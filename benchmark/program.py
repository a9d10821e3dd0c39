"""What the entries share of the system under test, kd_pointcloud_tpu_torch:
its network built from a configuration file's sizes and the benchmark's
seeded weights, and the state of its optimizer as the check reads it.

Only this module, entries/*.py and steps/*.py import the program; the
reference (reference/) and the yardstick (work.py, tracing.py, metrics/)
import none of it.
"""

from __future__ import annotations

import torch

from kd_pointcloud_tpu_torch.models import BidPointFlowNet
from kd_pointcloud_tpu_torch.models.config import ModelConfig
from kd_pointcloud_tpu_torch.train.state import make_optimizer


def model(cfg: dict, weights: dict, device) -> torch.nn.Module:
    """The program's network for a configuration file's model entry, its
    parameters and statistics set to weights. Every entry is a ModelConfig
    wiring of the one BidPointFlowNet; the entry's "reference" names the
    benchmark's reference network and is no field of it."""
    fields = {k: tuple(v) if isinstance(v, list) else v
              for k, v in cfg.items() if k != "reference"}
    net = BidPointFlowNet(ModelConfig(**fields), device=device)
    net.load_state_dict(weights, strict=True)
    return net


def optimizer(student: torch.nn.Module, train: dict):
    """The program's Adam over student's parameters, at the configuration
    file's training settings."""
    return make_optimizer(student, train["learning_rate"],
                          train["weight_decay"])


def adam_moments(student: torch.nn.Module, opt, key: str) -> list:
    """Adam's moment key ("exp_avg" or "exp_avg_sq") of each parameter in
    student's order; zeros where Adam holds none (it took no step)."""
    out = []
    for p in student.parameters():
        m = opt.state.get(p, {}).get(key)
        out.append(torch.zeros_like(p) if m is None else m)
    return out


def adam_steps(student: torch.nn.Module, opt) -> torch.Tensor:
    """Adam's step count of the first parameter, as a tensor (0 before the
    first step); read it with float() once the window has closed."""
    p = next(student.parameters())
    t = opt.state.get(p, {}).get("step")
    return torch.zeros(()) if t is None else t.detach().clone()


def first_gradients(student: torch.nn.Module, opt) -> dict:
    """The first step's gradient as Adam took it (weight decay added), by
    parameter name, from its first moment after one step: m / (1 - beta1);
    zeros where Adam holds no moment (it took no step)."""
    beta1 = opt.param_groups[0]["betas"][0]
    names = [n for n, _ in student.named_parameters()]
    return {n: m / (1 - beta1)
            for n, m in zip(names, adam_moments(student, opt, "exp_avg"))}
