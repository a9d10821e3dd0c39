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

On a data mesh (parallel/) each rank runs the teacher and the student on
its rows, and the loss -- each of the 13 KD losses -- is evaluated on every
rank over the gathered outputs of the global batch (parallel.GatheredView),
so batch sums, products of batch means and the t_history normalisation
are the global batch's; the student's (and the Bridge's) gradients are
averaged over the ranks, as train/loop.py make_train_step does.

A step opens the spans kd.teacher, kd.student, kd.loss, kd.backward and
kd.optimizer (the gradients' mean over a mesh and the update) around its
phases; they are on only while a profiler records (perf/trace.py).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from ..device import use_full_fp32
from ..losses import (att_iter_loss, bridge_ht_loss,
                      cross_bidirection_loss_ht)
from ..nn.pointconv import batch_stats_over
from ..parallel import Mesh, global_view, sync_grads
from ..perf.trace import annotate


def _forward(model, batch):
    return model(batch["pos1"], batch["pos2"], batch["norm1"], batch["norm2"])


def apply_frozen(t_model, batch: Dict[str, torch.Tensor]):
    """The teacher's outputs on batch: eval mode, no autograd."""
    t_model.eval()
    with torch.no_grad():
        return _forward(t_model, batch)


def make_distill_step(t_model, s_model, optimizer, gamma: float = 0.3,
                      beta: float = 0.8, layer=(2, 3),
                      loss_fn: Optional[Callable] = None,
                      mesh: Optional[Mesh] = None):
    """fn(batch) -> loss (detached): the frozen teacher's forward, the
    student's forward in train mode, loss_fn(s_out, t_out, batch), backward
    and one optimizer step of the student.

    The default loss is the reference's own choice (distilTrain.py:173),
    cross_bidirection_loss_ht(gamma, beta, layer), which compares the
    student's feat1s[l] with the concatenation of both teacher clouds'
    features: it needs hint layers twice the teacher's width, and with the
    shipped teacher / lighttoken_res pairing (equal widths) it raises a
    shape error, as in the reference and the JAX package. The shipped
    config selects biDirection_loss_ht (make_named_loss).

    With mesh, batch holds this rank's rows and loss_fn sees the global
    batch's outputs and batch."""
    use_full_fp32()

    def default_loss(s_out, t_out, batch):
        return cross_bidirection_loss_ht(
            s_out["flows"], s_out["feat1s"], s_out["fps_idx1"], batch["flow"],
            t_out["flows"], t_out["feat1s"], t_out["feat2s"], gamma, beta,
            layer)

    loss_fn = loss_fn or default_loss

    def step(batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        with annotate("kd.teacher"):
            t_out = apply_frozen(t_model, batch)
        with annotate("kd.student"):
            s_model.train()
            optimizer.zero_grad(set_to_none=True)
            with batch_stats_over(s_model, mesh):
                s_out = _forward(s_model, batch)
        with annotate("kd.loss"):
            loss = loss_fn(global_view(mesh, s_out),
                           global_view(mesh, t_out), global_view(mesh, batch))
        with annotate("kd.backward"):
            loss.backward()
        with annotate("kd.optimizer"):
            sync_grads(mesh, s_model.parameters())
            optimizer.step()
        return loss.detach()

    return step


def make_fast_distill_step(t_model, s_model, optimizer, gamma: float = 0.6,
                           layers=(1, 2), mesh: Optional[Mesh] = None):
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

    return make_distill_step(t_model, s_model, optimizer, loss_fn=loss_fn,
                             mesh=mesh)


def make_bridge_distill_step(t_model, s_model, bridge, s_optimizer,
                             b_optimizer, gamma: float = 0.3,
                             beta: float = 0.8, layer: int = 3,
                             mesh: Optional[Mesh] = None):
    """fn(batch) -> loss (detached): the Bridge mixes the frozen teacher's
    layer-`layer` features of both clouds, and bridge_ht_loss hints the
    student's features at that layer towards them.

    Unlike the reference, whose bridge optimizer steps over gradients that
    never flow (distillBridge.py:173-175), the bridge trains jointly through
    the hint loss with its own optimizer, as in the JAX package. With
    b_optimizer=None the bridge is frozen: it runs without autograd and
    keeps its parameters.

    With mesh, batch holds this rank's rows; the Bridge runs on this rank's
    teacher features and the loss on the global batch's."""
    use_full_fp32()

    def step(batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        with annotate("kd.teacher"):
            t_out = apply_frozen(t_model, batch)
        with annotate("kd.student"):
            s_model.train()
            s_optimizer.zero_grad(set_to_none=True)
            if b_optimizer is not None:
                b_optimizer.zero_grad(set_to_none=True)
            with batch_stats_over(s_model, mesh):
                s_out = global_view(mesh, _forward(s_model, batch))
        # the loss's phase holds the Bridge, which makes its hint targets
        with annotate("kd.loss"):
            with torch.set_grad_enabled(b_optimizer is not None):
                br = global_view(mesh, dict(zip(("br1", "br2"), bridge(
                    t_out["feat1s"][layer], t_out["feat2s"][layer]))))
            t_out, batch = global_view(mesh, t_out), global_view(mesh, batch)
            loss = bridge_ht_loss(s_out["flows"], s_out["feat1s"],
                                  s_out["feat2s"], s_out["fps_idx1"],
                                  batch["flow"], t_out["flows"], br["br1"],
                                  br["br2"], gamma, beta, layer)
        with annotate("kd.backward"):
            loss.backward()
        with annotate("kd.optimizer"):
            sync_grads(mesh, s_model.parameters())
            s_optimizer.step()
            if b_optimizer is not None:
                sync_grads(mesh, bridge.parameters())
                b_optimizer.step()
        return loss.detach()

    return step
