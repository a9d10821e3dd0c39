"""The entry "train" (entries/train.py) driven on the CPU at test size, as
test_bench_faults.py drives the KD entry (which also holds the sound run
of every cell): `correct` comes out false for each fault a supervised
step can have, in set-up's checked steps and in the window's; and the
cell's frozen work counts one model with its backward."""

import json
import time

import pytest

from benchmark import work
from benchmark.harness import ROOT, Cell, by_name, entry_of, run_cell
from benchmark.tests.tiny import tiny_cell

SEED = 2 ** 31 + 4242
CELLS = [w["name"] for w in
         json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]
TRAIN = [c for c in CELLS if Cell(c).workload["entry"] == "train"]


def _small(cell):
    c = tiny_cell(cell)
    c.workload["batch"] = 2
    return c


def _run(cell):
    result, _ = run_cell(_small(cell), SEED, 0.5, False, "cpu",
                         time.perf_counter())
    return result


def _failed(result) -> set:
    assert not result["correct"]
    return {n for n, c in result["checks"].items() if c["value"] > c["limit"]}


def _break_step(monkeypatch, wrap):
    """The train entry's program with its step replaced by wrap(step,
    opt), from the first call on."""
    train = by_name("entries", "train")
    build = train.build

    def broken(*args):
        step, model, opt = build(*args)
        return wrap(step, opt), model, opt

    monkeypatch.setattr(train, "build", broken)


@pytest.mark.parametrize("cell", TRAIN)
def test_unchanged_state_fails(cell, monkeypatch):
    def wrap(step, opt):
        opt.step = lambda *a, **k: None
        return step

    _break_step(monkeypatch, wrap)
    result = _run(cell)
    assert {"change_gap", "window_change_gap"} <= _failed(result)
    assert result["checks"]["change_gap"]["value"] == pytest.approx(1.0)


@pytest.mark.parametrize("cell", TRAIN)
def test_half_batch_fails(cell, monkeypatch):
    _break_step(monkeypatch, lambda step, opt: lambda batch: step(
        {k: v[:v.shape[0] // 2] for k, v in batch.items()}))
    assert {"grad_gap", "window_grad_gap"} <= _failed(_run(cell))


@pytest.mark.parametrize("cell", TRAIN)
def test_altered_loss_fails(cell, monkeypatch):
    _break_step(monkeypatch, lambda step, opt: lambda batch: step(batch)
                * 1.001)
    assert {"first_loss_gap", "window_first_loss_gap"} <= _failed(_run(cell))


@pytest.mark.parametrize("cell", TRAIN)
def test_stale_window_input_fails(cell, monkeypatch):
    """Sound through set-up's checked steps, then the batch last seen there
    again and again: only the window's numbers can see it."""
    def wrap(step, opt):
        seen = []

        def stale(batch):
            if len(seen) < _small(cell).workload["check_steps"]:
                seen.append(batch)
            return step(seen[-1])

        return stale

    _break_step(monkeypatch, wrap)
    failed = _failed(_run(cell))
    assert failed and all(n.startswith("window_") for n in failed)


@pytest.mark.parametrize("cell", TRAIN)
def test_runs_count_one_model_with_its_backward(cell):
    """A training pair: the model's differentiable products three times,
    its 3-D kNN and FPS once; the cost volume's bound is in the kernels'
    counts, its operations in the dense count (IN_DENSE_COUNT)."""
    c = _small(cell)
    w = c.workload
    B, N = w["batch"], w["points"]
    dense, calls = work.forward_sites(c.config["models"][w["model"]], B, N,
                                      True)
    tot = work.kernel_totals(calls)
    got = work.cell_work(entry_of(c).runs(c), w)
    assert got["flops"] * B == pytest.approx(
        3 * dense + tot["knn"][0] + tot["fps"][0], rel=1e-12)
    assert set(got["kernels"]) == {"knn", "fps", "cost_volume"}
    assert len(calls["cost_volume"]) == 4
