"""Run one cell of BENCHMARK.json once on the card and print its result.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout. Set-up (imports, the kernels' build, seeded
weights and inputs on the device, warm-up) is timed as setup_s; then the
window runs the cell's calls for --seconds; with --trace 1 a short traced
stretch follows and the per-layer metrics are read from it. Last, the
benchmark's plain reference checks a sample of what the window produced.
The last line of standard output is the result's JSON object; the numbers
compared, each beside its limit, are the last lines of standard error.
The run fails, and prints no result, without enough CUDA devices, or if
JAX or the JAX package is loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def _caches() -> None:
    """Every build and kernel cache at a fixed path inside the checkout."""
    cache = ROOT / "build" / "benchmark_cache"
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = str(cache / sub)
    os.environ.setdefault("USE_FLAX", "0")
    os.environ["OMP_NUM_THREADS"] = "1"     # one busy host thread a run


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _caches()
    sys.path.insert(0, str(ROOT))
    import torch

    torch.set_num_threads(1)

    from benchmark.harness import Cell, forbidden_modules, run_cell

    cell = Cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"benchmark: {cell.name} needs {cell.chips} CUDA device(s); "
              f"torch.cuda.is_available()={torch.cuda.is_available()}, "
              f"device_count={torch.cuda.device_count()}", file=sys.stderr)
        return 2
    result, lines = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                             "cuda", T_START)
    found = forbidden_modules()
    if found:
        print(f"benchmark: the process holds {found}", file=sys.stderr)
        return 3
    result["device"]["power_limit_w"] = _power_limit()
    for name, value, limit in lines:
        print(f"check {name} = {value!r} (limit {limit!r})", file=sys.stderr)
    print(json.dumps(result))
    return 0


def _power_limit():
    """The card's power limit in watts, from nvidia-smi, or None."""
    import subprocess

    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader,nounits"],
                             capture_output=True, text=True, timeout=20)
        return float(out.stdout.split()[0])
    except (OSError, ValueError, IndexError, subprocess.TimeoutExpired):
        return None


if __name__ == "__main__":
    sys.exit(main())
