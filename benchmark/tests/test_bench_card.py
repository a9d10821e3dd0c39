"""On the card, at each cell's own size: sound runs of the program read
within every limit, and the control (the reference with TF32 on in the
program's place) and the planted faults fail one, on three seeds.

    python -m pytest -q benchmark/tests/test_bench_card.py -m card

Several minutes a cell; they skip where torch sees no card."""

import json

import pytest

from benchmark.harness import ROOT, Cell, entry_of

CELLS = [w["name"] for w in
         json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]

SEEDS = (2 ** 31 + 101, 2 ** 31 + 202, 2 ** 31 + 303)


def _fails(numbers: dict, limits: dict) -> bool:
    return any(v > limits[k] for k, v in numbers.items())


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_control_and_faults_fail(card, cell):
    c = Cell(cell)
    limits = c.workload["limits"]
    for seed in SEEDS:
        row = entry_of(c).readings(c, seed, 2.0, card)
        assert not _fails(row["program"], limits), row
        assert _fails(row["control"], limits), row
        for key in row:
            if key.startswith("fault_"):
                assert _fails(row[key], limits), (key, row)
