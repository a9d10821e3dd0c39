"""BENCHMARK.json and every file it names: the contract's shapes, names
and units, which cell reports which metric, and the per-layer readers on a
small hand-made Chrome trace."""

import json
import re
from pathlib import Path

import pytest

from benchmark.harness import BENCH_DIR, ROOT, Cell, by_name, read_metric
from benchmark.tracing import STRETCH, Stretch

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in SPEC["workloads"]]


def _line(text):
    return isinstance(text, str) and 0 < len(text) <= 200 \
        and "\n" not in text and "\t" not in text


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert 1 <= SPEC["run_seconds"] <= 51
    assert isinstance(SPEC["run_seconds"], int)
    assert all(_line(w) for w in SPEC["command"])
    for p in SPEC["paths"]:
        assert (ROOT / p).is_dir() and not p.startswith("/")
    assert len(json.dumps(SPEC).encode()) <= 64 * 1024


def test_names_units_and_keys():
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["source"]) and _line(c["why"])
        assert (ROOT / c["file"]).is_file()
        assert c["file"].startswith(tuple(p + "/" for p in SPEC["paths"]))
        assert all(NAME.match(k) for k in c["reduced"])
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert _line(w["why"]) and w["chips"] in (1, 4)
        assert (BENCH_DIR / "workloads" / f"{w['name']}.json").is_file()
    metrics = SPEC["end_to_end"] + SPEC["per_layer"]
    names = [m["name"] for m in metrics]
    assert len(set(names)) == len(names)
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for m in SPEC["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in SPEC["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert _line(m["layer"])
        assert (BENCH_DIR / "metrics" / f"{m['name']}.py").is_file()
    assert "setup_s" in names


def test_every_cell_reports_what_its_metrics_move():
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e
        moved = e2e[m["moves"]]
        for cell in m.get("workloads", CELLS):
            assert cell in CELLS
            assert cell in moved.get("workloads", CELLS), (m["name"], cell)
    for cell in CELLS:
        c = Cell(cell)
        reported = {m["name"] for m in c.end_to_end}
        assert "setup_s" in reported and len(reported) >= 2
        assert c.per_layer
    used = {w["config"] for w in SPEC["workloads"]}
    assert used == {c["name"] for c in SPEC["configs"]}


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_agree(cell):
    c = Cell(cell)
    w, entry = c.workload, next(x for x in SPEC["workloads"]
                                if x["name"] == cell)
    assert w["config"] == entry["config"]
    models = c.config["models"]
    for key in ("model", "teacher", "student"):
        if key in w:
            assert w[key] in models
    assert set(w["limits"]) and all(v >= 0 for v in w["limits"].values())


@pytest.mark.parametrize("cell", CELLS)
def test_cell_names_its_files(cell):
    """What a cell drives is found by the names in its workload file: its
    entry, and a KD entry's program step and reference loss."""
    w = Cell(cell).workload
    entry = by_name("entries", w["entry"])
    for attr in ("Driver", "build", "runs", "readings"):
        assert hasattr(entry, attr), (w["entry"], attr)
    if "step" in w:
        assert callable(by_name("steps", w["step"]).build)
    if "loss" in w:
        assert callable(by_name("reference/losses", w["loss"]).loss)


def test_by_name_refuses_a_missing_file():
    with pytest.raises(KeyError):
        by_name("entries", "no_such_entry")


def _trace():
    """A 10 ms stretch (1000-11000 us) serving 2 pairs: knn_kernel 2.5
    ms, the pool forward 1 ms and backward 1 ms, a copy 0.5 ms, a
    cross_pool_kernel inside the pool's time that no pool reader counts;
    a settle kernel and a launch before the stretch; 4 launches inside."""
    ev = [dict(ph="X", cat="user_annotation", name=STRETCH, ts=1000,
               dur=10000),
          dict(ph="X", cat="kernel", name="spin_kernel", ts=500, dur=100),
          dict(ph="X", cat="cuda_runtime", name="cudaLaunchKernel", ts=400,
               dur=5),
          dict(ph="X", cat="kernel", name="void knn_kernel<32, 1>(float)",
               ts=1000, dur=2500),
          dict(ph="X", cat="kernel", name="void pool_kernel<32>(float)",
               ts=4000, dur=1000),
          dict(ph="X", cat="kernel", name="void pool_bwd_mask_kernel<32>()",
               ts=5000, dur=600),
          dict(ph="X", cat="kernel", name="void pool_bwd_kernel<32>()",
               ts=5600, dur=400),
          dict(ph="X", cat="kernel", name="void cross_pool_kernel<32>()",
               ts=4200, dur=100),
          dict(ph="X", cat="gpu_memcpy", name="Memcpy DtoH", ts=7000,
               dur=500),
          dict(ph="X", cat="cpu_op", name="aten::sort", ts=6000, dur=1000)]
    for t, name in ((1001, "cudaLaunchKernel"), (3500, "cudaLaunchKernelExC"),
                    (3600, "cuLaunchKernel"), (3700, "cudaGraphLaunch"),
                    (3800, "cudaMemcpyAsync")):
        ev.append(dict(ph="X", cat="cuda_runtime", name=name, ts=t, dur=2))
    work = dict(flops=1e9, kernels=dict(knn=(0, 0, 1e-4), pool=(0, 0, 2e-4),
                                        pool_bwd=(0, 0, 5e-5),
                                        fps=(0, 0, 0.0)))
    return Stretch(ev, 2, work, rate=67.0)


def test_stretch_reduction():
    s = _trace()
    assert s.window_s == pytest.approx(0.01)
    assert s.busy_s == pytest.approx(0.005)
    assert s.launches() == 4
    bd = s.breakdown()
    assert bd["device_ops"][0] == ["void knn_kernel<32, 1>(float)",
                                   pytest.approx(0.0025)]
    assert [(n, round(d, 6)) for n, d in bd["idle_gaps"]] == [
        ("host: no op", 0.0035),          # 7500 -> 11000
        ("host: aten::sort", 0.001),      # 6000 -> 7000
        ("host: no op", 0.0005)]          # 3500 -> 4000


@pytest.mark.parametrize("name,value", [
    ("host_launches_per_pair.train", 2.0),
    ("device_idle_pct.train", 50.0),
    ("mfu.train", 0.1),
    ("knn_roofline.train", 8.0),
    ("pool_roofline.train", 25.0),
    ("pool_roofline.eval", 40.0),
    ("knn_roofline.eval", 8.0)])
def test_readers(name, value):
    assert read_metric(name, _trace()) == pytest.approx(value)


def test_reader_without_its_kernel_reads_nothing():
    s = _trace()
    s.device = [e for e in s.device if "knn" not in e["name"]]
    assert read_metric("knn_roofline.eval", s) is None
    assert read_metric("knn_roofline.train", s) is None


def test_every_reader_file_is_listed():
    listed = {m["name"] for m in SPEC["per_layer"]}
    files = {p.name[:-3] for p in (BENCH_DIR / "metrics").glob("*.py")}
    assert files == listed
    assert all(Path(BENCH_DIR / "workloads" / f"{c}.json").is_file()
               for c in CELLS)
