"""Readings that the limits of `correct` are set from, for one cell, on the
card at the cell's own size (the benchmark's runs do not run this); each
seed's readings are its entry's readings() (entries/<entry>.py):

* program: the numbers a sound run of the program gives against the
  reference after a short window at the cell's load, on each seed;
* control: the reference run with TF32 on (the nearest precision below
  the configuration's float32) in the program's place;
* faults, planted in the reference put in the program's place: "half"
  (KD: the loss and its mean over half of each batch's rows) and "row"
  (eval: one point's flow of each answer zeroed); a step that leaves the
  state unchanged reads 1 on change_gap by definition and needs no run.

    python3 benchmark/control.py --workload <cell> --seeds 1,2,3 \
        [--controls N] [--seconds 2] [--out chiprun_out/control_<cell>.json]

Prints one JSON line a seed and writes them all to --out.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--controls", type=int, default=None,
                    help="read the control and the faults on the first N "
                    "seeds only (default: every seed)")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from benchmark.harness import Cell, entry_of

    cell = Cell(args.workload)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rows = []
    for i, seed in enumerate(int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        controls = args.controls is None or i < args.controls
        row = entry_of(cell).readings(cell, seed, args.seconds, "cuda",
                                      controls)
        row.update(workload=cell.name, seed=seed,
                   seconds=time.perf_counter() - t)
        rows.append(row)
        print(json.dumps(row), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text("\n".join(json.dumps(r) for r in rows)
                                  + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
