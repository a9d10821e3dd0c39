"""Pieces of the KD experiment loop.

Port of kd_pointcloud_tpu/train/distill_experiment.py make_named_loss and
compute_teacher_history. The epoch loop (distill) waits for the port's data
loaders.
"""

from __future__ import annotations

from typing import Iterable, Mapping, Optional

import torch

from .. import losses as loss_lib
from .distill import apply_frozen
from .loop import batch_to_device


def compute_teacher_history(t_model, loader: Iterable,
                            max_batches: Optional[int] = None) -> list:
    """The frozen teacher's multi-scale loss on each batch of loader
    (numpy batches, pos1, pos2, norm1, norm2, flow, paths), which
    attentiveImitationLoss normalises by (distilTrain.py:142)."""
    device = next(t_model.parameters()).device
    history = []
    for i, batch_np in enumerate(loader):
        if max_batches is not None and i >= max_batches:
            break
        batch = batch_to_device(batch_np, device)
        out = apply_frozen(t_model, batch)
        history.append(float(loss_lib.multi_scale_loss(
            out["flows"], batch["flow"], out["fps_idx1"])))
    return history


def make_named_loss(name: str, args: Mapping):
    """fn(s_out, t_out, batch, t_history=None) -> loss for a KD loss named
    as the reference's entry scripts name it, with gamma, beta, gamma2 and
    hint_layers from args (distilTrain.py:174 and its alternatives)."""
    gamma = args.get("gamma", 0.3)
    beta = args.get("beta", 0.8)
    layers = tuple(args.get("hint_layers", (2, 3)))

    def fn(s_out, t_out, batch, t_history=None) -> torch.Tensor:
        if name == "loss_fn_kd_2":
            return loss_lib.loss_fn_kd_2(s_out["flows"], s_out["fps_idx1"],
                                         batch["flow"], t_out["flows"],
                                         t_out["fps_idx1"], gamma)
        if name == "attentiveImitationLoss":
            return loss_lib.attentive_imitation_loss(
                s_out["flows"], s_out["fps_idx1"], batch["flow"],
                t_out["flows"], t_out["fps_idx1"], t_history, gamma)
        if name == "biDirectionLoss":
            return loss_lib.bidirection_loss(
                s_out["flows"], s_out["fps_idx1"], s_out["fps_idx2"],
                batch["flow"], t_out["flows"], t_out["fps_idx1"],
                gamma, args.get("gamma2", gamma), beta)
        if name == "biDirection_loss_ht":
            return loss_lib.bidirection_loss_ht(
                s_out["flows"], s_out["feat1s"], s_out["feat2s"],
                s_out["fps_idx1"], batch["flow"], t_out["flows"],
                t_out["feat1s"], t_out["feat2s"], gamma, beta,
                layer=layers[-1])
        if name == "cross_biDirection_loss_ht":
            return loss_lib.cross_bidirection_loss_ht(
                s_out["flows"], s_out["feat1s"], s_out["fps_idx1"],
                batch["flow"], t_out["flows"], t_out["feat1s"],
                t_out["feat2s"], gamma, beta, layers)
        if name == "cross_loss":
            return loss_lib.cross_loss(
                s_out["flows"], s_out["crosses"], s_out["fps_idx1"],
                batch["flow"], t_out["flows"], t_out["crosses"], gamma, beta)
        raise ValueError(f"unknown kd loss {name}")

    return fn
