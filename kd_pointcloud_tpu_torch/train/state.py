"""Optimizer and learning-rate schedules.

Port of kd_pointcloud_tpu/train/state.py. The optimizer is the reference's
(train_bid_pointconv.py:117-124): Adam(betas=(0.9, 0.999), eps=1e-8) with
additive L2 weight decay 1e-4 folded into the gradient before the moment
updates -- torch.optim.Adam's weight_decay, which is the JAX package's
add_decayed_weights -> scale_by_adam -> scale(-lr) chain (not AdamW). The
schedule is StepLR(step_size=100 epochs, gamma=0.5) with the learning rate
clipped at >= 1e-5, or the reference's custom schedule, set once an epoch.

flax's TrainState has no counterpart here: the model holds parameters and
BatchNorm statistics, the optimizer its moments and step count.
"""

from __future__ import annotations

import torch

LEARNING_RATE_CLIP = 1e-5


def step_lr(base_lr: float, epoch: int, step_size: int = 100,
            gamma: float = 0.5, clip: float = LEARNING_RATE_CLIP) -> float:
    return max(base_lr * gamma ** (epoch // step_size), clip)


def custom_lr(epoch: int, lrs, lr_switch_epochs) -> float:
    """The reference's custom schedule: lrs and switch epochs stored
    descending; the lr is the first entry whose switch epoch the current
    epoch has reached."""
    for lr, switch in zip(lrs, lr_switch_epochs):
        if epoch >= switch:
            return lr
    return lrs[-1]


def lr_for_epoch(args, epoch: int) -> float:
    """The epoch's learning rate from a config mapping: the custom schedule
    when configured, StepLR otherwise."""
    if args.get("custom_lr"):
        return custom_lr(epoch, args.get("lrs"), args.get("lr_switch_epochs"))
    return step_lr(args.get("learning_rate"), epoch)


def make_optimizer(model: torch.nn.Module, learning_rate: float = 1e-3,
                   weight_decay: float = 1e-4) -> torch.optim.Adam:
    return torch.optim.Adam(model.parameters(), lr=learning_rate,
                            betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=weight_decay)


def set_learning_rate(optimizer: torch.optim.Optimizer, lr: float) -> None:
    for group in optimizer.param_groups:
        group["lr"] = lr
