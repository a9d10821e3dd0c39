"""Evaluation of the port: 3-D metrics and the eval forward."""

from .metrics import evaluate_3d, evaluate_3d_torch
from .runner import (evaluate_model, make_eval_forward,
                     make_eval_metrics_step, synthetic_pairs)

__all__ = ["evaluate_3d", "evaluate_3d_torch", "evaluate_model",
           "make_eval_forward", "make_eval_metrics_step", "synthetic_pairs"]
