"""The reference's training pieces: the multi-scale flow loss that the KD
losses (reference/losses/<name>.py, KD-PointCloud loss_functions.py) build
on, Adam with additive L2 weight decay, and one KD step.

Adam follows torch.optim.Adam(betas=(0.9, 0.999), eps=1e-8, weight_decay):
the decay is added to the gradient before the moments.
"""

from __future__ import annotations

import math

import torch

from .ops import gather_points

ALPHA = (0.02, 0.04, 0.08, 0.16)


def safe_norm(x, dim=-1):
    return torch.sqrt(torch.clamp((x * x).sum(dim), min=1e-20))


def downsample_gt(gt, fps_idxs):
    out = [gt]
    for idx in fps_idxs:
        out.append(gather_points(out[-1], idx))
    return out


def multi_scale_loss(pred_flows, gt, fps_idxs, alpha=ALPHA):
    """sum over levels and iterations of alpha_l mean_B sum_N |pred - gt_l|."""
    offset = len(fps_idxs) - len(pred_flows) + 1
    gts = downsample_gt(gt, fps_idxs)
    total = 0.0
    for i, entry in enumerate(pred_flows):
        for f in entry if isinstance(entry, (list, tuple)) else [entry]:
            total = total + alpha[i] * safe_norm(f - gts[i + offset]).sum(1)
    return total.mean()


class Adam:
    """torch.optim.Adam's update, written out; m and v a parameter."""

    def __init__(self, params, lr, weight_decay, betas=(0.9, 0.999),
                 eps=1e-8):
        self.params = list(params)
        self.lr, self.wd, self.betas, self.eps = lr, weight_decay, betas, eps
        self.m = [torch.zeros_like(p) for p in self.params]
        self.v = [torch.zeros_like(p) for p in self.params]
        self.t = 0

    @torch.no_grad()
    def step(self):
        self.t += 1
        b1, b2 = self.betas
        c1 = 1 - b1 ** self.t
        c2 = math.sqrt(1 - b2 ** self.t)
        for p, m, v in zip(self.params, self.m, self.v):
            g = p.grad + self.wd * p
            m.mul_(b1).add_(g, alpha=1 - b1)
            v.mul_(b2).addcmul_(g, g, value=1 - b2)
            p.addcdiv_(m, v.sqrt() / c2 + self.eps, value=-self.lr / c1)
            p.grad = None


def kd_step(teacher, student, opt: Adam, loss_fn, batch):
    """One step: the frozen teacher in eval mode without autograd, the
    student in train mode, the loss, backward, Adam. Returns the loss."""
    args = (batch["pos1"], batch["pos2"], batch["norm1"], batch["norm2"])
    teacher.eval()
    with torch.no_grad():
        t_out = teacher(*args)
    student.train()
    loss = loss_fn(student(*args), t_out, batch)
    loss.backward()
    opt.step()
    return loss.detach()
