"""What the benchmark loads, and how it fails without a card.

The modules a run loads are imported in a fresh interpreter and their
top-level names compared whole: neither JAX nor the JAX package
kd_pointcloud_tpu (the program's own package only starts with that name),
and the reference loads nothing of the program."""

import json
import shutil
import subprocess
import sys

from benchmark.harness import BENCH_DIR, FORBIDDEN, ROOT

RUN_MODULES = ("benchmark.harness", "benchmark.program", "benchmark.check",
               "benchmark.tracing", "benchmark.work", "benchmark.inputs",
               "benchmark.readers", "benchmark.control")
# files found by name: every one a run or control.py may load
RUN_FOLDERS = ("entries", "steps", "metrics", "kernels", "reference/losses",
               "reference/nets")
REFERENCE = ("benchmark.reference.outputs", "benchmark.reference.train",
             "benchmark.reference.ops")


def _top_level_after(modules, folders=()) -> set:
    code = (f"import sys, json; sys.path.insert(0, {str(ROOT)!r})\n"
            f"import importlib\n"
            f"for m in {list(modules)!r}: importlib.import_module(m)\n"
            f"from benchmark.harness import BENCH_DIR, by_name\n"
            f"for f in {list(folders)!r}:\n"
            f"    for p in sorted((BENCH_DIR / f).glob('*.py')):\n"
            f"        by_name(f, p.name[:-3])\n")
    code += "print(json.dumps(sorted({n.split('.')[0] for n in sys.modules})))"
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_run_loads_no_jax():
    names = _top_level_after(RUN_MODULES, RUN_FOLDERS)
    assert "kd_pointcloud_tpu_torch" in names
    assert not names & set(FORBIDDEN), names & set(FORBIDDEN)


def test_reference_loads_nothing_of_the_program():
    names = _top_level_after(REFERENCE, ("reference/losses",
                                         "reference/nets"))
    assert not names & (set(FORBIDDEN) | {"kd_pointcloud_tpu_torch"})


def test_guard_compares_whole_names(monkeypatch):
    from benchmark import harness

    monkeypatch.setitem(sys.modules, "kd_pointcloud_tpu_torch_x", sys)
    assert "kd_pointcloud_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "kd_pointcloud_tpu.models", sys)
    assert harness.forbidden_modules() == ["kd_pointcloud_tpu"]


def _run(cwd, timeout=300):
    return subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "teacher-eval-b1",
         "--seed", str(2 ** 31 + 11), "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=timeout, cwd=cwd,
        env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})


def test_run_fails_without_a_card():
    out = _run(ROOT)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA device" in out.stderr


def test_run_fails_with_only_the_benchmark(tmp_path):
    """A checkout that holds only BENCHMARK.json and benchmark/: no
    result."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(BENCH_DIR, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run(tmp_path)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
