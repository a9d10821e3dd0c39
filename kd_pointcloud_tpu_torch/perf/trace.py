"""Profiler traces.

Counterpart of kd_pointcloud_tpu/utils/trace.py, on torch.profiler instead
of jax.profiler: a trace of a block written as a Chrome trace (open it in
chrome://tracing or ui.perfetto.dev), named regions inside it, and a
step's name for a train loop. On the card the trace shows the port's
kernels by their own names (fps_kernel, knn_kernel, pool_kernel, ...);
CUPTI sees their ctypes launches as it sees PyTorch's.

On an H100, CUPTI at times loses the kernel records (not the launches'
records) of the first kernels of a profiler session, and of the first
kernels of the recorded step after a warm-up step. So ``recording``, and
``trace`` through it, records the block only after a warm-up step, whose
records it discards, of ``WARM_UP_KERNELS`` tiny kernels, and after a
settle of
``SETTLE_KERNELS`` launches of torch.cuda._sleep's ``spin_kernel`` (no
model launches it) at the start of the recorded step, which takes such a
loss in the block's place: a reader of the trace leaves the settle's
kernels out (``SETTLE_KERNEL``). ``trace`` holds the trace to
``ops.kernels.LAUNCHES``: it raises when the trace holds another number
of a port kernel's records than the block launched.
"""

from __future__ import annotations

import contextlib
import json
import os
import re
from collections import Counter
from typing import Iterator

import torch
from torch.profiler import (ProfilerActivity, profile, record_function,
                            schedule)

from ..ops import kernels

TRACE_FILE = "trace.json"
# the first kernel each launch counter's wrapper puts on the card, once a
# launch (the pool backward's second kernel runs only where d_u or d_v is
# wanted); a mangled name puts the name's length (digits) before it and
# its template arguments (I...E) after it
_FIRST_KERNEL = re.compile(r"(?<![A-Za-z_])(fps_pruned|fps|knn|pool_bwd_mask"
                           r"|pool|cross_pool)_kernel(?=[<(I])")
_COUNTER = {"pool_bwd_mask": "pool_bwd"}
WARM_UP_KERNELS = 512
SETTLE_KERNELS = 512
SETTLE_KERNEL = "spin_kernel"         # torch.cuda._sleep's


def kernel_records(events) -> dict:
    """Records of each port kernel in a Chrome trace's events, by launch
    counter (the keys of ops.kernels.LAUNCHES)."""
    out = Counter()
    for e in events:
        hit = (e.get("cat") == "kernel"
               and _FIRST_KERNEL.search(str(e.get("name", ""))))
        if hit:
            out[_COUNTER.get(hit.group(1), hit.group(1))] += 1
    return dict(out)


@contextlib.contextmanager
def recording(activities) -> Iterator[profile]:
    """A torch.profiler profile of the block: where the activities hold
    the card's, its recording starts after a warm-up step that launches
    WARM_UP_KERNELS kernels and waits for them, and the recorded step
    opens with SETTLE_KERNELS launches of SETTLE_KERNEL, waited for,
    before the block."""
    on_card = ProfilerActivity.CUDA in activities
    with profile(activities=activities,
                 schedule=schedule(wait=0, warmup=1, active=1)) as prof:
        if on_card:
            x = torch.zeros(1, device="cuda")
            for _ in range(WARM_UP_KERNELS):
                x.add_(1)
            torch.cuda.synchronize()
        prof.step()
        if on_card:
            for _ in range(SETTLE_KERNELS):
                torch.cuda._sleep(1000)
            torch.cuda.synchronize()
        yield prof


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[str]:
    """Trace the block, the card's activity too where one is present, into
    <log_dir>/trace.json:

        with trace("runs/t") as d:
            run_steps()

    On the card it then raises if the trace lost a record of a port
    kernel that the block launched (the file is written all the same)."""
    os.makedirs(log_dir, exist_ok=True)
    on_card = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU]
    if on_card:
        activities.append(ProfilerActivity.CUDA)
    before = dict(kernels.LAUNCHES)
    with recording(activities) as prof:
        yield log_dir
        if on_card:
            torch.cuda.synchronize()
    path = os.path.join(log_dir, TRACE_FILE)
    prof.export_chrome_trace(path)
    if not on_card:
        return
    launched = {n: c - before[n] for n, c in kernels.LAUNCHES.items()
                if c > before[n]}
    with open(path) as f:
        traced = kernel_records(json.load(f)["traceEvents"])
    if traced != launched:
        raise RuntimeError(f"{path} holds the port's kernels {traced}, the "
                           f"block launched {launched}: the profiler lost "
                           f"records")


def annotate(name: str):
    """A named region inside a trace."""
    return record_function(name)


def step_annotation(step: int):
    """A train step's region, named as torch.profiler names its steps."""
    return record_function(f"ProfilerStep#{step}")
