"""A run driven on the CPU at test size, past the harness's look for a
card, with the timed path sound and then broken underneath: `correct`
holds for the sound path and comes out false for each fault a cell can
have (one card, so no exchange between chips to leave out), in set-up's
checked steps and in the window's."""

import json
import time

import pytest

from benchmark.harness import ROOT, Cell, by_name, run_cell
from benchmark.tests.tiny import tiny_cell

SEED = 2 ** 31 + 12345
CELLS = [w["name"] for w in
         json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]
EVAL = [c for c in CELLS if Cell(c).workload["entry"] == "eval"]
KD = [c for c in CELLS if Cell(c).workload["entry"] == "kd"]


def _run(cell):
    result, _ = run_cell(tiny_cell(cell), SEED, 0.5, False, "cpu",
                         time.perf_counter())
    return result


def _failed(result) -> set:
    assert not result["correct"]
    return {n for n, c in result["checks"].items() if c["value"] > c["limit"]}


def _break_step(monkeypatch, wrap):
    """The KD entry's program with its step replaced by wrap(step, opt),
    from the first call on."""
    kd = by_name("entries", "kd")
    build = kd.build

    def broken(*args):
        step, student, opt = build(*args)
        return wrap(step, opt), student, opt

    monkeypatch.setattr(kd, "build", broken)


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    result = _run(cell)
    assert result["correct"], result["checks"]
    assert result["attempted"] >= 1 and result["failed"] == 0
    assert list(result)[-1] == "checks"


@pytest.mark.parametrize("cell", EVAL)
def test_altered_answer_fails(cell, monkeypatch):
    ev = by_name("entries", "eval")
    build = ev.build

    def altered_build(cfg, weights, device):
        fwd = build(cfg, weights, device)

        def altered(*args):
            flow = fwd(*args).clone()
            flow[:, 7] += 0.5 * flow.norm(dim=-1).median()
            return flow

        return altered

    monkeypatch.setattr(ev, "build", altered_build)
    assert _failed(_run(cell)) == {"flow_far_points"}


@pytest.mark.parametrize("cell", KD)
def test_unchanged_state_fails(cell, monkeypatch):
    def wrap(step, opt):
        opt.step = lambda *a, **k: None
        return step

    _break_step(monkeypatch, wrap)
    result = _run(cell)
    assert {"change_gap", "window_change_gap"} <= _failed(result)
    assert result["checks"]["change_gap"]["value"] == pytest.approx(1.0)


@pytest.mark.parametrize("cell", KD)
def test_half_batch_fails(cell, monkeypatch):
    _break_step(monkeypatch, lambda step, opt: lambda batch: step(
        {k: v[:v.shape[0] // 2] for k, v in batch.items()}))
    assert {"grad_gap", "window_grad_gap"} <= _failed(_run(cell))


@pytest.mark.parametrize("cell", KD)
def test_altered_loss_fails(cell, monkeypatch):
    _break_step(monkeypatch, lambda step, opt: lambda batch: step(batch)
                * 1.001)
    assert {"first_loss_gap", "window_first_loss_gap"} <= _failed(_run(cell))


@pytest.mark.parametrize("cell", KD)
def test_stale_window_input_fails(cell, monkeypatch):
    """A step sound through set-up's checked steps that then replays the
    batch it last saw there, as a captured step over stale inputs would:
    only the window's numbers can see it."""
    def wrap(step, opt):
        seen = []

        def stale(batch):
            if len(seen) < tiny_cell(cell).workload["check_steps"]:
                seen.append(batch)
            return step(seen[-1])

        return stale

    _break_step(monkeypatch, wrap)
    failed = _failed(_run(cell))
    assert failed and all(n.startswith("window_") for n in failed)


@pytest.mark.parametrize("cell", KD)
def test_stale_window_optimizer_fails(cell, monkeypatch):
    """Adam's step count frozen after set-up's checked steps (its bias
    correction replayed from a captured state): only the window's
    numbers can see it."""
    def wrap(step, opt):
        calls = []

        def frozen(batch):
            calls.append(1)
            loss = step(batch)
            if len(calls) > tiny_cell(cell).workload["check_steps"]:
                for st in opt.state.values():
                    st["step"] -= 1
            return loss

        return frozen

    _break_step(monkeypatch, wrap)
    failed = _failed(_run(cell))
    assert failed and all(n.startswith("window_") for n in failed)
