"""Knowledge-distillation train steps.

Port of kd_pointcloud_tpu/train/distill.py make_distill_step,
make_fast_distill_step and make_bridge_distill_step (reference
distilTrain.py:156-182, fast_distillTrain.py:161-189,
distillBridge.py:141-188). As train/loop.py make_train_step, a step is a
plain function over the models and optimizers, which it updates in place.

The teacher is frozen, as the JAX package's _apply_frozen: it runs in
eval() (BatchNorm on its running statistics, which never move) under
torch.no_grad(), so no autograd graph is recorded for it and its pool
launches no backward kernel; it is never switched to train(). The student
runs in train().
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from ..device import use_full_fp32
from ..losses import (att_iter_loss, bridge_ht_loss,
                      cross_bidirection_loss_ht)


def _forward(model, batch):
    return model(batch["pos1"], batch["pos2"], batch["norm1"], batch["norm2"])


def apply_frozen(t_model, batch: Dict[str, torch.Tensor]):
    """The teacher's outputs on batch: eval mode, no autograd."""
    t_model.eval()
    with torch.no_grad():
        return _forward(t_model, batch)


def make_distill_step(t_model, s_model, optimizer, gamma: float = 0.3,
                      beta: float = 0.8, layer=(2, 3),
                      loss_fn: Optional[Callable] = None):
    """fn(batch) -> loss (detached): the frozen teacher's forward, the
    student's forward in train mode, loss_fn(s_out, t_out, batch), backward
    and one optimizer step of the student.

    The default loss is the reference's own choice (distilTrain.py:173),
    cross_bidirection_loss_ht(gamma, beta, layer), which compares the
    student's feat1s[l] with the concatenation of both teacher clouds'
    features: it needs hint layers twice the teacher's width, and with the
    shipped teacher / lighttoken_res pairing (equal widths) it raises a
    shape error, as in the reference and the JAX package. The shipped
    config selects biDirection_loss_ht (make_named_loss)."""
    use_full_fp32()

    def default_loss(s_out, t_out, batch):
        return cross_bidirection_loss_ht(
            s_out["flows"], s_out["feat1s"], s_out["fps_idx1"], batch["flow"],
            t_out["flows"], t_out["feat1s"], t_out["feat2s"], gamma, beta,
            layer)

    loss_fn = loss_fn or default_loss

    def step(batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        t_out = apply_frozen(t_model, batch)
        s_model.train()
        optimizer.zero_grad(set_to_none=True)
        loss = loss_fn(_forward(s_model, batch), t_out, batch)
        loss.backward()
        optimizer.step()
        return loss.detach()

    return step


def make_fast_distill_step(t_model, s_model, optimizer, gamma: float = 0.6,
                           layers=(1, 2)):
    """fn(batch) -> loss (detached): the attentive per-iteration KD step of
    an iterative teacher (bifeat) into a student (fg), as make_distill_step
    with att_iter_loss(gamma, layers): the student's flow at each of
    `layers` imitates every teacher iteration's, weighted by 1 - softmax
    over iterations of the teacher's error against the ground truth
    (configs/fast_distill.yaml: gamma 0.6, layers [1, 2])."""

    def loss_fn(s_out, t_out, batch):
        return att_iter_loss(s_out["flows"], s_out["fps_idx1"], batch["flow"],
                             t_out["flows"], t_out["fps_idx1"], gamma,
                             layers)

    return make_distill_step(t_model, s_model, optimizer, loss_fn=loss_fn)


def make_bridge_distill_step(t_model, s_model, bridge, s_optimizer,
                             b_optimizer, gamma: float = 0.3,
                             beta: float = 0.8, layer: int = 3):
    """fn(batch) -> loss (detached): the Bridge mixes the frozen teacher's
    layer-`layer` features of both clouds, and bridge_ht_loss hints the
    student's features at that layer towards them.

    Unlike the reference, whose bridge optimizer steps over gradients that
    never flow (distillBridge.py:173-175), the bridge trains jointly through
    the hint loss with its own optimizer, as in the JAX package. With
    b_optimizer=None the bridge is frozen: it runs without autograd and
    keeps its parameters."""
    use_full_fp32()

    def step(batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        t_out = apply_frozen(t_model, batch)
        s_model.train()
        s_optimizer.zero_grad(set_to_none=True)
        if b_optimizer is not None:
            b_optimizer.zero_grad(set_to_none=True)
        s_out = _forward(s_model, batch)
        with torch.set_grad_enabled(b_optimizer is not None):
            br1, br2 = bridge(t_out["feat1s"][layer], t_out["feat2s"][layer])
        loss = bridge_ht_loss(s_out["flows"], s_out["feat1s"],
                              s_out["feat2s"], s_out["fps_idx1"],
                              batch["flow"], t_out["flows"], br1, br2,
                              gamma, beta, layer)
        loss.backward()
        s_optimizer.step()
        if b_optimizer is not None:
            b_optimizer.step()
        return loss.detach()

    return step
