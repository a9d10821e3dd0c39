"""Cells at test size: the cell's own files with the models' point counts
and neighbour counts cut as the program's tiny_config cuts them, and a few
pairs of 256 points."""

from benchmark.harness import Cell

TINY_POINTS = [256, 128, 64, 32, 16]


def tiny_models(models: dict) -> dict:
    for m in models.values():
        m.update(npoints=list(TINY_POINTS), flow_nei=16, feat_nei=8)
    return models


def tiny_cell(name: str) -> Cell:
    cell = Cell(name)
    tiny_models(cell.config["models"])
    cell.workload.update(points=TINY_POINTS[0], pairs=4, batches=4, check=2,
                         warmup=1)
    if cell.workload["entry"] == "kd":
        cell.workload["batch"] = 2
    return cell
