"""One run of one cell: set-up, the measured window, the traced stretch,
the correctness check and the result's line.

Everything that belongs to a cell is found by name: its entry in
BENCHMARK.json, workloads/<cell>.json (the entry it drives, batch, points,
pairs, scene parameters, check sizes and limits), configs/<config>.json
(the models' sizes and the training settings), entries/<entry>.py (the
driver of the workload's entry: the program it builds, its window and the
reference comparison), and metrics/<metric>.py (one reader a per-layer
metric). An entry may look up further files by the workload's names in
the same way (entries/kd.py: steps/<step>.py, reference/losses/<loss>.py),
a model entry names its reference network (reference/nets/<net>.py), and
each kind of kernel call that a reference forward records has its work
formula (kernels/<kind>.py; lookup.py finds them all). A new cell, entry,
step, loss, metric, network or kernel is files added, no file edited.
"""

from __future__ import annotations

import gc
import json
import statistics
import sys
import time
from pathlib import Path

import torch

from . import check
from .lookup import BENCH_DIR, ROOT, by_name
from .work import cell_work

FORBIDDEN = ("jax", "jaxlib", "flax", "kd_pointcloud_tpu")


def forbidden_modules() -> list:
    """Top-level names in sys.modules, compared whole, that the process
    must not hold: JAX and the JAX package (the program's own package
    only starts with that name)."""
    return sorted({name.split(".")[0] for name in list(sys.modules)}
                  & set(FORBIDDEN))


class Cell:
    """A cell of BENCHMARK.json with its files: name, chips, workload
    (workloads/<name>.json), config (configs/<config>.json), end_to_end and
    per_layer (the metric entries this cell reports)."""

    def __init__(self, name: str, root: Path = ROOT):
        spec = json.loads((root / "BENCHMARK.json").read_text())
        entry = next((w for w in spec["workloads"] if w["name"] == name),
                     None)
        if entry is None:
            raise KeyError(f"BENCHMARK.json has no workload {name!r}")
        self.name, self.chips = name, entry["chips"]
        conf = next(c for c in spec["configs"] if c["name"] == entry["config"])
        self.config = json.loads((root / conf["file"]).read_text())
        self.workload = json.loads(
            (BENCH_DIR / "workloads" / f"{name}.json").read_text())

        def mine(m):
            return name in m.get("workloads", [name])

        self.end_to_end = [m for m in spec["end_to_end"] if mine(m)]
        reported = {m["name"] for m in self.end_to_end}
        self.per_layer = [m for m in spec["per_layer"]
                          if m["moves"] in reported and mine(m)]


def entry_of(cell: "Cell"):
    """entries/<entry>.py of the cell's workload."""
    return by_name("entries", cell.workload["entry"])


def read_metric(name: str, stretch):
    """metrics/<name>.py's read(stretch): a number, or None where the
    trace holds nothing for it to read."""
    return by_name("metrics", name).read(stretch)


def sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def free(device):
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def p95(values: list) -> float:
    """The 95th percentile (inclusive quantiles) of all values."""
    if len(values) < 2:
        return max(values)
    return statistics.quantiles(values, n=20, method="inclusive")[18]


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device,
             t_start: float) -> tuple:
    """(result, lines): the result line's object and the numbers compared,
    each (name, value, limit)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    on_card = torch.device(device).type == "cuda"
    entry = entry_of(cell)
    driver = entry.Driver(cell, seed, device)
    sync(device)
    setup_s = time.perf_counter() - t_start
    win = driver.window(seconds)
    dev = dict(platform="gpu" if on_card else "cpu",
               kind=torch.cuda.get_device_name(0) if on_card else "cpu",
               count=cell.chips,
               memory_peak_bytes=torch.cuda.max_memory_allocated()
               if on_card else 0)
    found = forbidden_modules()
    if found:
        raise RuntimeError(f"the process holds {found} after the window")
    # a call that raises ends the run without a result, so none failed
    result = dict(correct=False, attempted=win["attempted"], failed=0,
                  metrics={}, device=dev)
    if trace:
        from .tracing import Stretch, trace_events
        calls = cell.workload["trace_calls"]
        events = trace_events(driver.traced, calls)
        stretch = Stretch(events, driver.pairs_of(calls),
                          cell_work(entry.runs(cell), cell.workload),
                          win["pairs"] / win["seconds"])
        dev.update(busy_s=stretch.busy_s, window_s=stretch.window_s)
        for m in cell.per_layer:
            value = read_metric(m["name"], stretch)
            if value is not None:
                result["metrics"][m["name"]] = dict(value=value,
                                                    unit=m["unit"])
        result["breakdown"] = stretch.breakdown()
    else:
        values = dict(win["metrics"], setup_s=setup_s)
        for m in cell.end_to_end:
            result["metrics"][m["name"]] = dict(value=values[m["name"]],
                                                unit=m["unit"])
    driver.release()
    free(device)
    ok, lines = check.judge(driver.numbers(), cell.workload["limits"])
    result["correct"] = ok
    result["checks"] = {n: dict(value=v, limit=lim) for n, v, lim in lines}
    return result, lines
