"""Files found by a name: every file of the benchmark that belongs to one
entry, KD step, loss, per-layer metric, kernel formula or reference
network is <folder>/<name>.py under a root of ROOTS, loaded by by_name;
and the reference network of a configuration file's model entry.

A model entry names its network under the key "reference", a module
reference/nets/<name>.py that gives Net(cfg) -> nn.Module; without the
key it is DEFAULT_NET. Such a module imports nothing of the program, and
its imports are absolute (benchmark.reference.*): a file loaded by name
has no package parent.
"""

from __future__ import annotations

import importlib.util
import sys
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
ROOTS = (BENCH_DIR,)      # searched in order; each lies inside the checkout
DEFAULT_NET = "pointflownet"


def by_name(folder: str, name: str):
    """The module of the file <folder>/<name>.py under the first root of
    ROOTS that holds it, loaded once a process (a name may hold dots, as a
    metric's does)."""
    path = next((r / folder / f"{name}.py" for r in ROOTS
                 if (r / folder / f"{name}.py").is_file()), None)
    if path is None:
        raise KeyError(f"benchmark/{folder} has no {name}.py")
    key = ".".join(path.parent.relative_to(ROOT).parts) + f":{name}"
    if key not in sys.modules:
        spec = importlib.util.spec_from_file_location(key, path)
        module = importlib.util.module_from_spec(spec)
        sys.modules[key] = module
        try:
            spec.loader.exec_module(module)
        except BaseException:
            del sys.modules[key]
            raise
    return sys.modules[key]


def network(cfg: dict):
    """The reference network of a model entry, as its module's Net(cfg)
    builds it (on the current default device)."""
    return by_name("reference/nets",
                   cfg.get("reference", DEFAULT_NET)).Net(cfg)
