"""The benchmark's frozen operation and byte counts, and the H100's peaks.

Every count here is a function of a configuration's sizes and the batch,
so it reads the same whatever the measured program runs:

* kernel formulas (operations, bytes) of one call at its shapes, each
  input read once and each output written once: kernels/<kind>.py
  work(*site), one file a kind of call that a reference forward records
  (reference/ops.py record): the 3-D kNN, FPS, the cost-volume pool and
  its backward, and whatever a network adds. A kind recorded without a
  formula raises; it is never counted as zero. The feature kNN alone is
  recorded for model_flops and is no kernel of its own (NOT_KERNELS);
* the model's operations a pair: the matrix products of the reference
  forward (torch.utils.flop_counter on the meta device, 2 a multiply-add;
  the feature kNN's cross term among them), plus the formulas of the
  kinds whose operations it cannot see (a formula's IN_DENSE_COUNT is
  False: the 3-D kNN and FPS). Elementwise work is not counted. A forward
  with a backward (a student's in training) counts its differentiable
  products three times (forward, and the gradients of inputs and weights)
  and its searches once: the 3-D kNN, FPS and the feature kNN's product
  run without autograd.

The call sites come from the reference forward itself (reference/ops.py
sites()), run on meta tensors at the workload's batch and points; the
network is the model entry's (lookup.py network).
"""

from __future__ import annotations

import torch
from torch.utils.flop_counter import FlopCounterMode

from .lookup import by_name, network
from .reference.ops import sites

# NVIDIA H100 SXM data sheet, dense: float32 without tensor cores (the
# port runs with TF32 off) and HBM3 bandwidth
PEAK_FLOPS = 67e12
PEAK_BYTES = 3.35e12
# recorded kinds that are no kernel of their own: the feature kNN, plain
# torch in the program, whose products are among the dense count
NOT_KERNELS = ("feature_knn",)


def formula(kind: str):
    """kernels/<kind>.py: work(*site) -> (operations, bytes) of one call,
    and IN_DENSE_COUNT, whether FlopCounterMode counts its operations."""
    try:
        return by_name("kernels", kind)
    except KeyError:
        raise KeyError(f"the reference forward records {kind!r} calls and "
                       f"benchmark/kernels has no {kind}.py: a kernel's work "
                       f"is never counted as zero") from None


def bound_s(ops, nbytes) -> float:
    """The least time of a call on the H100: operations over the float32
    peak or bytes over the memory bandwidth, whichever is larger."""
    return max(ops / PEAK_FLOPS, nbytes / PEAK_BYTES)


def forward_sites(cfg: dict, batch: int, points: int, grad: bool):
    """(dense flops, sites) of one reference forward of batch pairs of
    points points, on meta tensors; grad runs it as a student in training
    (the pools then have a backward)."""
    with torch.device("meta"):
        model = network(cfg)
        x = [torch.empty(batch, points, 3) for _ in range(4)]
    model.train(grad)
    with torch.set_grad_enabled(grad), sites() as calls, \
            FlopCounterMode(display=False) as dense:
        model(*x)
    return int(dense.get_total_flops()), calls


def kernel_totals(calls) -> dict:
    """(ops, bytes, bound seconds) by kernel over recorded call sites:
    every kind recorded but NOT_KERNELS, by its formula."""
    out = {}
    for kind, kind_sites in calls.items():
        if kind in NOT_KERNELS:
            continue
        work = formula(kind).work
        total = out[kind] = [0, 0, 0.0]
        for site in kind_sites:
            ops, nbytes = work(*site)
            total[0] += ops
            total[1] += nbytes
            total[2] += bound_s(ops, nbytes)
    return {k: tuple(v) for k, v in out.items()}


def feature_knn_flops(calls) -> int:
    """The feature kNN's cross-term products at the recorded sites (among
    the dense count; they run without autograd)."""
    return sum(2 * B * S * N * D
               for B, S, N, D, _ in calls.get("feature_knn", ()))


def model_flops(dense: int, calls, grad: bool = False) -> int:
    """A forward's counted operations: the dense products plus the formulas
    of the kernels outside them (the 3-D kNN and FPS; the pool's products
    are among the dense ones); with grad, its backward too: the
    differentiable products twice more."""
    searches = sum(ops for kind, (ops, _, _) in kernel_totals(calls).items()
                   if not formula(kind).IN_DENSE_COUNT)
    if not grad:
        return dense + searches
    nograd = feature_knn_flops(calls)
    return 3 * (dense - nograd) + nograd + searches


def cell_work(runs: list, workload: dict) -> dict:
    """The frozen counts of a cell, a pair: flops (the model's operations),
    and for each kernel that a run records its (ops, bytes, bound
    seconds). runs: (model sizes, with a backward) of each forward a pair
    runs (the entry's runs(cell))."""
    B, N = workload["batch"], workload["points"]
    flops = 0
    kern = {}
    for cfg, grad in runs:
        dense, calls = forward_sites(cfg, B, N, grad)
        flops += model_flops(dense, calls, grad)
        for name, (o, b, s) in kernel_totals(calls).items():
            total = kern.setdefault(name, [0, 0, 0.0])
            total[0] += o
            total[1] += b
            total[2] += s
    return dict(flops=flops / B,
                kernels={k: (o / B, b / B, s / B)
                         for k, (o, b, s) in kern.items()})
