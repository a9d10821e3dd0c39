"""What every entry's comparison shares: the reference network of a model
entry (lookup.py network) built from the seeded weights, the numbers of a
training step's comparison, the TF32 control's switch, and the judgement
of each number against its limit.

An entry (entries/<entry>.py) decides what of the timed path it compares
and how the reference recomputes it; see each entry's docstring.

A training step's numbers, program against reference: the loss of the
first step compared (later steps' losses move by Adam's round-off: a
gradient entry near zero takes a whole step of either sign, see PERF.md);
the norm of the first gradient as Adam took it, by the worst parameter;
the norm of each parameter's change over the steps, by the worst
parameter, leaving out parameters whose reference gradient is under a
thousandth of the median parameter's (Adam moves those by round-off
alone). A norm's gap is taken against the reference's norm of that
parameter or of the median parameter, whichever is larger.
"""

from __future__ import annotations

import contextlib
import statistics

import torch
from torch import nn

from .lookup import network

ZERO_GRAD = 1e-3          # a reference gradient under this share of the
                          # median parameter's moves by round-off alone


def reference_model(cfg: dict, weights: dict, device) -> nn.Module:
    """The model entry's reference network on device, its parameters and
    statistics set to weights."""
    net = network(cfg).to(device)
    net.load_state_dict(weights, strict=True)
    return net


def meta_model(cfg: dict) -> nn.Module:
    """The reference network's names and shapes, on no device."""
    with torch.device("meta"):
        return network(cfg)


@contextlib.contextmanager
def tf32():
    """The control's precision: TF32 on for float32 products and
    convolutions, off again after the block."""
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False


def _worst_gap(got: dict, want: dict, keep=None) -> float:
    names = [n for n in want if keep is None or n in keep]
    scale = statistics.median(want[n] for n in names)
    return max(abs(got[n] - want[n]) / max(want[n], scale) for n in names)


def step_numbers(prog: dict, ref: dict, prefix: str = "") -> dict:
    """prog and ref: losses (a list), grad (name -> norm of the first
    step's gradient as Adam took it), change (name -> norm of the
    parameter's change over the steps). Names carry prefix."""
    first, want = prog["losses"][0], ref["losses"][0]
    med = statistics.median(ref["grad"].values())
    moved = {n for n, g in ref["grad"].items() if g >= ZERO_GRAD * med}
    return {f"{prefix}first_loss_gap": abs(first - want) / abs(want),
            f"{prefix}grad_gap": _worst_gap(prog["grad"], ref["grad"]),
            f"{prefix}change_gap": _worst_gap(prog["change"], ref["change"],
                                              moved)}


def norms(tensors: dict) -> dict:
    return {n: float(t.double().norm()) for n, t in tensors.items()}


def changes(after: dict, before: dict) -> dict:
    return {n: float((after[n].double() - before[n].double()).norm())
            for n in after}


def judge(numbers: dict, limits: dict):
    """(correct, lines): every number at or under its limit; a number with
    no limit, or a NaN, fails."""
    ok, lines = True, []
    for name, value in numbers.items():
        limit = limits.get(name)
        good = limit is not None and value == value and value <= limit
        ok = ok and good
        lines.append((name, value, limit))
    return ok, lines
