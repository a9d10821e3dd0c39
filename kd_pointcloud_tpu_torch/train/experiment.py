"""Experiment assembly: config -> datasets / loaders / model / optimizer ->
the teacher's epoch loop.

Port of kd_pointcloud_tpu/train/experiment.py (reference
train_bid_pointconv.py:20-181): the glue the reference spreads across its
entry scripts lives here once, and the cli/ entries are thin wrappers.

Launched by torchrun (cli.train calls parallel.init_from_env), the loop is
data-parallel over the process group, with the JAX package's batch
semantics: batch_size_per_device: true scales the config's batch by the
world size, a global batch that does not divide over the ranks is padded
(parallel.data_parallel_plan; the pad rows are masked out of the loss),
every rank loads the same global batch and runs its rows, and rank 0 alone
writes logs and checkpoints. Without a process group it runs on one
device, as the JAX package does on one.
"""

from __future__ import annotations

import logging
import os.path as osp
import time
from typing import Optional

import numpy as np
import torch

from ..data import DATASETS, Augmentation, DataLoader, ProcessData
from ..device import resolve_device
from ..models import PRESETS, BidPointFlowNet
from ..parallel import (Mesh, data_parallel_plan, make_mesh, replicate,
                        resolve_global_batch)
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


def build_loaders(args: Config, train_ds, val_ds,
                  batch_size: Optional[int] = None):
    """The shuffled train loader (drop_last) and the val loader, which
    keeps every sample: its short final batch is padded and the padding
    masked out of the metrics; batches of batch_size (default the
    config's)."""
    workers = args.get("workers", 2)
    bs = batch_size if batch_size is not None else args.batch_size
    train_loader = DataLoader(train_ds, bs, shuffle=True, drop_last=True,
                              num_workers=workers)
    val_loader = DataLoader(val_ds, bs, shuffle=False, drop_last=False,
                            pad_last=True, num_workers=workers)
    return train_loader, val_loader


def run_dir_and_logger(mesh: Mesh, base: str, model_name: str,
                       logger_name: str, log_file: str, **dir_kw):
    """(run_dir, logger): rank 0 makes the run directory and logs to its
    logs/log_file and to stdout; every other rank logs nothing and takes
    rank 0's run directory."""
    if not mesh.is_main:
        logger = make_logger(logger_name, to_stdout=False)
        logger.addHandler(logging.NullHandler())
        got = [None]
        torch.distributed.broadcast_object_list(got, src=0, group=mesh.group)
        return got[0], logger
    run_dir = make_experiment_dir(base, model_name, **dir_kw)
    if mesh.group is not None:
        torch.distributed.broadcast_object_list([run_dir], src=0,
                                                group=mesh.group)
    return run_dir, make_logger(logger_name,
                                osp.join(run_dir, "logs", log_file))


def resume_epoch(ckpt_epoch: int, best_epe: float) -> int:
    """Full checkpoints record the last completed epoch, so the run goes on
    at the next; bare weight checkpoints carry their epoch in the file name
    (train_bid_pointconv.py:115) and restart it."""
    return ckpt_epoch + 1 if best_epe != float("inf") else ckpt_epoch


def run_epoch(step, loader, device, max_steps: Optional[int],
              pad_to: Optional[int] = None,
              mesh: Optional[Mesh] = None) -> dict:
    """One pass of step over loader's batches (at most max_steps), each
    padded to pad_to and, with mesh, cut to this rank's rows: the mean
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
        losses.append(step(batch_to_device(batch_np, device, pad_to, mesh)))
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
    checkpoint written or None; None on every rank but 0).

    In a process group (see the module's docstring) every rank runs the
    loop on its rows of each global batch, and all of them return the same
    numbers."""
    device = resolve_device(device)
    mesh = make_mesh(devices=device)
    run_dir, logger = run_dir_and_logger(
        mesh, args.get("experiment_dir", "./experiment"), args.model_name,
        args.model_name, f"train_{args.model_name}_sceneflow.txt")
    logger.info("PARAMETER ... %s", dict(args))

    model = build_model(args, device=device)
    train_ds, val_ds = build_datasets(args)
    # batch_size_per_device: true scales the config's batch by the world
    # size; otherwise the global batch is padded to the mesh, pad rows
    # masked out of the loss, so data parallelism engages either way
    global_bs = resolve_global_batch(
        args.batch_size, args.get("batch_size_per_device", False), mesh.size)
    train_loader, val_loader = build_loaders(args, train_ds, val_ds,
                                             global_bs)
    mesh, sharding, padded_bs = data_parallel_plan(global_bs, logger, mesh)
    step_mesh = sharding.mesh if sharding is not None else None
    train_pad = padded_bs if (sharding is not None
                              and padded_bs != global_bs) else None
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
    replicate(mesh, model)

    train_step = make_train_step(model, optimizer, mesh=step_mesh)
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
                            max_steps_per_epoch, train_pad, step_mesh)
            logger.info("EPOCH %d %s mean loss: %f", epoch, blue("train"),
                        rec["loss"])

            t_eval = time.perf_counter()
            eval_epe3d, eval_loss = eval_sceneflow(
                eval_step, val_loader, device, train_pad, step_mesh)
            rec.update(epoch=epoch, lr=lr, epe=eval_epe3d,
                       eval_loss=eval_loss, checkpoint=None,
                       eval_s=time.perf_counter() - t_eval)
            logger.info("EPOCH %d %s mean epe3d: %f  mean eval loss: %f",
                        epoch, blue("eval"), eval_epe3d, eval_loss)

            if eval_epe3d < best_epe:
                best_epe = eval_epe3d
                if mesh.is_main:
                    rec["checkpoint"] = save_checkpoint(
                        osp.join(run_dir, "checkpoints"), args.model_name,
                        epoch, best_epe, full_state_tree(model, optimizer,
                                                         epoch, best_epe))
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
