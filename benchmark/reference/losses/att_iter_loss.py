"""att_iter_loss (KD-PointCloud loss_functions.py): the ground truth through
the student's FPS chain, plus, at each of hint_layers, each teacher
iteration's flow imitated with weight 1 - softmax over iterations of its
error against the ground truth. Workload keys: gamma, hint_layers."""

import torch
import torch.nn.functional as F

from benchmark.reference.train import (ALPHA, downsample_gt,
                                       multi_scale_loss, safe_norm)


def loss(spec: dict):
    """fn(student outputs, teacher outputs, batch) -> the loss."""
    gamma, layers = spec["gamma"], spec["hint_layers"]

    def fn(s, t, batch):
        loss1 = multi_scale_loss(s["flows"], batch["flow"], s["fps_idx1"])
        gts = downsample_gt(batch["flow"], t["fps_idx1"])
        hint = 0.0
        for layer in layers:
            errs = torch.stack([((tf - gts[layer]) ** 2).sum((1, 2))
                                for tf in t["flows"][layer]], dim=1)
            ratio = 1 - F.softmax(errs, dim=1)
            for it, tf in enumerate(t["flows"][layer]):
                diff = safe_norm(s["flows"][layer] - tf).sum(1)
                hint = hint + ALPHA[layer] * (ratio[:, it] * diff).sum()
        return gamma * loss1 + (1 - gamma) * hint

    return fn
