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

Spans. ``annotate(name)`` opens a named span of the program: a
record_function range, which the trace holds as a ``user_annotation``
event on the host's timeline, the clock its CUDA runtime calls and kernels
share. A span is on exactly when a torch profiler records (its active
step); otherwise ``annotate`` returns one shared no-op context manager, so
the program runs the same ops, syncs and launches either way. The
program's spans (``SPANS``):

  kd.teacher, kd.student, kd.loss, kd.backward, kd.optimizer
      the phases of a KD step (train/distill.py)
  train.forward, train.loss, train.backward, train.optimizer
      the phases of a supervised train step (train/loop.py
      make_train_step)
  eval.forward
      an eval request (eval/runner.py make_eval_forward)
  model.encode, model.cross, model.flow_head, model.upsample
      the model's stages (models/bid_pointflow.py)
  model.cost_volume
      a PointConvFlow cost volume and its two kNN searches
      (nn/experimental.py; inside model.cross on cross="pwc"'s path)
  knn_features, knn_features.sync
      the feature-space kNN and its host sync, one a 2048-query chunk
      (ops/knn.py)

An eval request answered by a CUDA graph's replay (eval/graphs.py) opens
eval.forward only: the model's Python, and its spans, ran at capture.
``eval_graph_counts()`` reads how often the eval forward captured,
replayed and ran eager.

Reading a trace: ``idle_by_span(events)`` takes the events of a trace
that ``trace`` wrote (``json.load(f)["traceEvents"]``) and returns the
card's idle seconds by the innermost span open on the host where each
idle gap starts (``OUTSIDE`` where none is), which names the phase or
stage that leaves the card waiting:

    with trace("runs/t"):
        for batch in batches:
            step(batch)
    with open("runs/t/trace.json") as f:
        print(idle_by_span(json.load(f)["traceEvents"]))
"""

from __future__ import annotations

import contextlib
import json
import os
import re
from collections import Counter
from typing import Iterator

import torch
from torch.autograd import profiler as _autograd_profiler
from torch.profiler import (ProfilerActivity, profile, record_function,
                            schedule)

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
SPANS = ("kd.teacher", "kd.student", "kd.loss", "kd.backward",
         "kd.optimizer", "train.forward", "train.loss", "train.backward",
         "train.optimizer", "eval.forward", "model.encode", "model.cross",
         "model.cost_volume", "model.flow_head", "model.upsample",
         "knn_features", "knn_features.sync")
OUTSIDE = "outside"
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_OFF = contextlib.nullcontext()


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
    # ops/ opens spans, so this module imports ops/ only where it is used
    from ..ops import kernels

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


def eval_graph_counts() -> dict:
    """How the eval forward answered its requests since the last
    ops.kernels.reset_launches(): CUDA graphs captured, requests answered
    by a replay, requests run eager (eval/graphs.py)."""
    from ..ops import kernels

    return dict(kernels.EVAL_GRAPHS)


def annotate(name: str):
    """A span of the program named name: record_function(name) while a
    torch profiler records, else one shared no-op context manager."""
    if _autograd_profiler._is_profiler_enabled:
        return record_function(name)
    return _OFF


def _end(e) -> float:
    return float(e["ts"]) + float(e["dur"])


def idle_by_span(events) -> dict:
    """The card's idle seconds in a trace's events, by the innermost span
    of SPANS open on the host where each gap starts (the shortest that
    holds its start), OUTSIDE where none is; the most first. The window
    runs from the first span's start to the last span's or device
    record's end; device records are kernels, copies and sets, the
    settle's kernels left out. {} where the trace holds no span."""
    spans = [e for e in events if e.get("ph") == "X"
             and e.get("cat") == "user_annotation"
             and e.get("name") in SPANS]
    if not spans:
        return {}
    t0 = min(float(e["ts"]) for e in spans)
    busy = sorted((float(e["ts"]), _end(e)) for e in events
                  if e.get("ph") == "X" and e.get("cat") in _DEVICE_CATS
                  and e.get("name") != SETTLE_KERNEL and _end(e) > t0)
    t1 = max([_end(e) for e in spans] + [b for _, b in busy])
    gaps, at = [], t0
    for a, b in busy + [(t1, t1)]:
        if a > at:
            gaps.append((at, a - at))
        at = max(at, b)
    out = {}
    for t, length in gaps:
        around = [e for e in spans if float(e["ts"]) <= t <= _end(e)]
        name = (min(around, key=lambda e: float(e["dur"]))["name"]
                if around else OUTSIDE)
        out[name] = out.get(name, 0.0) + length * 1e-6
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))
