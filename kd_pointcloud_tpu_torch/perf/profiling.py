"""Model profiling: parameters, operations, latency.

Counterpart of kd_pointcloud_tpu/utils/profiling.py (param_count,
cost_analysis, latency, profile_model; the reference's thop-based profiling
mains, models_bid_pointconv.py:680-713).

What the count counts. The JAX package asks XLA's cost analysis, which
counts its own lowering's elementwise ops too; this count makes no claim
to equal it. flop_count adds two parts:
  * dense: torch.utils.flop_counter.FlopCounterMode over the call's aten
    ops, which counts matrix products and convolutions (2 per
    multiply-add) and nothing elementwise;
  * kernels: the operations of every launch of the port's kernels
    (ops/kernels.py kernel_work: FPS, kNN, the pool), which a ctypes launch
    hides from dispatch. On the CPU the kernels' plain versions run
    instead; their aten ops are left out of the dense part and their
    kernel_work counted in the kernels part, so a configuration counts the
    same on both devices.
by_kernel also lists the plain PyTorch cost volume's calls ("cost_volume",
ops/kernels.py VISIBLE): its products are in the dense part, so its
operations are not added to the kernels part.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, Tuple

import torch
from torch.utils.flop_counter import FlopCounterMode

from ..eval.runner import make_eval_forward
from ..ops import kernels


def param_count(model: torch.nn.Module) -> int:
    """Trainable parameters, not buffers (BatchNorm statistics): the JAX
    package's param_count(variables["params"])."""
    return sum(p.numel() for p in model.parameters())


def flop_count(fn: Callable, *args) -> Dict[str, Any]:
    """Operations of one call fn(*args) (see the module docstring): flops
    (dense + kernels), dense_flops, kernel_flops, kernel_bytes and, by
    kernel name, calls, flops and bytes."""
    with kernels.counting() as count, \
            FlopCounterMode(display=False) as dense:
        fn(*args)
    dense_flops = int(dense.get_total_flops())
    return dict(flops=dense_flops + count.total_ops, dense_flops=dense_flops,
                kernel_flops=count.total_ops, kernel_bytes=count.total_bytes,
                by_kernel={n: dict(calls=count.calls[n], flops=count.ops[n],
                                   bytes=count.bytes[n])
                           for n in sorted(count.calls)})


def latency(fn: Callable, *args, warmup: int = 2, iters: int = 20
            ) -> Tuple[float, float]:
    """(mean ms a call, calls a second): `iters` calls after `warmup`, then
    one torch.cuda.synchronize() when an argument is on the card (as the
    JAX package times N dispatches and one host sync)."""
    on_card = any(torch.is_tensor(a) and a.is_cuda for a in args)

    def sync():
        if on_card:
            torch.cuda.synchronize()

    for _ in range(warmup):
        fn(*args)
    sync()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn(*args)
    sync()
    dt = (time.perf_counter() - t0) / iters
    return dt * 1000.0, 1.0 / dt


def profile_model(model: torch.nn.Module, *inputs, warmup: int = 2,
                  iters: int = 20) -> Dict[str, Any]:
    """params, the operations of one eval forward (flop_count's keys) and
    its latency (latency_ms, pairs_per_sec) on inputs (pos1, pos2, norm1,
    norm2), on the device they are on."""
    fwd = make_eval_forward(model)
    stats = dict(params=param_count(model), device=str(inputs[0].device))
    stats.update(flop_count(fwd, *inputs))
    ms, pps = latency(fwd, *inputs, warmup=warmup, iters=iters)
    stats.update(latency_ms=ms, pairs_per_sec=pps)
    return stats
