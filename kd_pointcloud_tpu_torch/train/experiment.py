"""Experiment assembly: config -> datasets / loaders / model / optimizer ->
the teacher's epoch loop.

Port of kd_pointcloud_tpu/train/experiment.py (reference
train_bid_pointconv.py:20-181): the glue the reference spreads across its
entry scripts lives here once, and the cli/ entries are thin wrappers.
The batch is the config's batch_size on one device; the JAX package's
batch_size_per_device and its padding of a batch to a device mesh wait for
the port's parallel/ module.
"""

from __future__ import annotations

import os.path as osp
import time
from typing import Optional

import numpy as np
import torch

from ..data import DATASETS, Augmentation, DataLoader, ProcessData
from ..device import resolve_device
from ..models import PRESETS, BidPointFlowNet
from ..utils import Config, blue, make_experiment_dir, make_logger
from .checkpoints import full_state_tree, restore_train_state, save_checkpoint
from .loop import (batch_to_device, eval_sceneflow, make_eval_step,
                   make_train_step)
from .state import lr_for_epoch, make_optimizer, set_learning_rate


def build_transforms(args: Config):
    dp = args.data_process
    train_tf = Augmentation(args.aug_together, args.aug_pc2,
                            depth_threshold=dp["DEPTH_THRESHOLD"],
                            no_corr=dp["NO_CORR"],
                            num_points=args.num_points,
                            allow_less_points=args.allow_less_points) \
        if "aug_together" in args else None
    val_tf = ProcessData(depth_threshold=dp["DEPTH_THRESHOLD"],
                         no_corr=dp["NO_CORR"], num_points=args.num_points,
                         allow_less_points=args.allow_less_points)
    return train_tf, val_tf


def build_datasets(args: Config, need_train: bool = True):
    train_tf, val_tf = build_transforms(args)
    cls = DATASETS[args.dataset]
    kwargs = dict(data_root=args.data_root)
    if args.dataset.startswith("FlyingThings"):
        train_ds = (cls(train=True, transform=train_tf,
                        full=args.get("full", True), **kwargs)
                    if need_train else None)
    else:
        train_ds = (cls(train=True, transform=train_tf, **kwargs)
                    if need_train else None)
    val_ds = cls(train=False, transform=val_tf, **kwargs)
    return train_ds, val_ds


def build_model(args: Config, preset_key: str = "model_preset",
                default: str = "teacher", device="cuda") -> BidPointFlowNet:
    """The config's preset, torch-default initialisation seeded with 0."""
    preset = args.get(preset_key, default)
    return BidPointFlowNet(PRESETS[preset], device=device,
                           generator=torch.Generator().manual_seed(0))


def build_loaders(args: Config, train_ds, val_ds):
    """The shuffled train loader (drop_last) and the val loader, which
    keeps every sample: its short final batch is padded and the padding
    masked out of the metrics."""
    workers = args.get("workers", 2)
    train_loader = DataLoader(train_ds, args.batch_size, shuffle=True,
                              drop_last=True, num_workers=workers)
    val_loader = DataLoader(val_ds, args.batch_size, shuffle=False,
                            drop_last=False, pad_last=True,
                            num_workers=workers)
    return train_loader, val_loader


def resume_epoch(ckpt_epoch: int, best_epe: float) -> int:
    """Full checkpoints record the last completed epoch, so the run goes on
    at the next; bare weight checkpoints carry their epoch in the file name
    (train_bid_pointconv.py:115) and restart it."""
    return ckpt_epoch + 1 if best_epe != float("inf") else ckpt_epoch


def run_epoch(step, loader, device, max_steps: Optional[int]) -> dict:
    """One pass of step over loader's batches (at most max_steps): the mean
    loss, and the seconds spent waiting on the loader and in all."""
    losses, load_s = [], 0.0
    t0 = time.perf_counter()
    batches = iter(loader)
    for i in range(len(loader)):
        t = time.perf_counter()
        batch_np = next(batches)
        load_s += time.perf_counter() - t
        if max_steps is not None and i >= max_steps:
            break
        losses.append(step(batch_to_device(batch_np, device)))
    loss = float(np.mean([float(l) for l in losses]))      # syncs
    return dict(loss=loss, steps=len(losses), load_s=load_s,
                train_s=time.perf_counter() - t0)


def train_teacher(args: Config, device="cuda",
                  max_epochs: Optional[int] = None,
                  max_steps_per_epoch: Optional[int] = None):
    """Teacher training loop (train_bid_pointconv.py:129-181): per epoch the
    learning rate (StepLR or the custom schedule), the train steps, an eval
    sweep, and a full checkpoint whenever the eval EPE3D improves.
    args.pretrain resumes from a checkpoint.

    Returns (model, optimizer, best_epe, run_dir, history): history holds
    a dict an epoch (lr, mean train loss, eval EPE3D and loss, seconds, the
    checkpoint written or None)."""
    device = resolve_device(device)
    run_dir = make_experiment_dir(args.get("experiment_dir", "./experiment"),
                                  args.model_name)
    logger = make_logger(args.model_name,
                         osp.join(run_dir, "logs",
                                  f"train_{args.model_name}_sceneflow.txt"))
    logger.info("PARAMETER ... %s", dict(args))

    model = build_model(args, device=device)
    train_ds, val_ds = build_datasets(args)
    train_loader, val_loader = build_loaders(args, train_ds, val_ds)
    # the JAX package draws one batch here to shape its initialisation;
    # drawing it too keeps the shuffles and augmentations of both packages
    # the same
    next(iter(train_loader))

    optimizer = make_optimizer(model, args.learning_rate, args.weight_decay)
    init_epoch, best_epe = 0, float("inf")
    if args.get("pretrain"):
        ckpt_epoch, best_epe, _ = restore_train_state(args.pretrain, model,
                                                      optimizer)
        init_epoch = resume_epoch(ckpt_epoch, best_epe)
        logger.info("loaded %s (resume at epoch %d, best epe %.4f)",
                    args.pretrain, init_epoch, best_epe)

    train_step = make_train_step(model, optimizer)
    eval_step = make_eval_step(model)
    history = []
    epochs = max_epochs if max_epochs is not None else args.epochs
    try:
        for epoch in range(init_epoch, epochs):
            t0 = time.perf_counter()
            lr = lr_for_epoch(args, epoch)
            set_learning_rate(optimizer, lr)
            logger.info("Learning rate: %f", lr)

            rec = run_epoch(train_step, train_loader, device,
                            max_steps_per_epoch)
            logger.info("EPOCH %d %s mean loss: %f", epoch, blue("train"),
                        rec["loss"])

            t_eval = time.perf_counter()
            eval_epe3d, eval_loss = eval_sceneflow(eval_step, val_loader,
                                                   device)
            rec.update(epoch=epoch, lr=lr, epe=eval_epe3d,
                       eval_loss=eval_loss, checkpoint=None,
                       eval_s=time.perf_counter() - t_eval)
            logger.info("EPOCH %d %s mean epe3d: %f  mean eval loss: %f",
                        epoch, blue("eval"), eval_epe3d, eval_loss)

            if eval_epe3d < best_epe:
                best_epe = eval_epe3d
                rec["checkpoint"] = save_checkpoint(
                    osp.join(run_dir, "checkpoints"), args.model_name, epoch,
                    best_epe, full_state_tree(model, optimizer, epoch,
                                              best_epe))
                logger.info("Save model to %s", rec["checkpoint"])
            logger.info("Best epe loss is: %.5f", best_epe)
            rec["seconds"] = time.perf_counter() - t0
            logger.info("EPOCH %d wall %.3f s (loader wait %.3f s, %d "
                        "steps %.3f s, eval %.3f s)", epoch, rec["seconds"],
                        rec["load_s"], rec["steps"], rec["train_s"],
                        rec["eval_s"])
            history.append(rec)
    finally:
        train_loader.close()
        val_loader.close()
    return model, optimizer, best_epe, run_dir, history
