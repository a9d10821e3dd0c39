"""KD experiment loops: standard, bridge, and fast/iterative distillation.

Port of kd_pointcloud_tpu/train/distill_experiment.py (reference
distilTrain.py:25-208, distillBridge.py:27-216, fast_distillTrain.py:25-217):
distill() builds a frozen teacher and a trainable student, runs the epoch
loop with the mode's KD step, evaluates the student each epoch (fast mode:
every FAST_RATIO-th epoch inside [FAST_FROM, FAST_UNTIL]) and checkpoints it
on best EPE; make_named_loss and compute_teacher_history are its pieces.

In a process group (torchrun) the loop is data-parallel as train_teacher's
is, with the JAX package's rule for KD (parallel.data_parallel_sharding):
batch_size_per_device: true scales the batch by the world size, and a
global batch that does not divide over the ranks is not sharded -- every
rank then computes the whole batch, and the run logs it (on the card the
pool backward's float atomics let the ranks' copies drift apart by
rounding there). The frozen teacher
is replicated, the student's and the Bridge's gradients are averaged over
the ranks, and rank 0 alone writes logs and checkpoints.
"""

from __future__ import annotations

import os.path as osp
import time
from typing import Iterable, Mapping, Optional

import torch

from .. import losses as loss_lib
from ..device import resolve_device
from ..models import PRESETS, BidPointFlowNet, Bridge
from ..parallel import (Mesh, data_parallel_sharding, global_view, make_mesh,
                        replicate, resolve_global_batch)
from ..utils import Config, blue
from .checkpoints import (full_state_tree, load_weights, restore_train_state,
                          save_checkpoint)
from .distill import (apply_frozen, make_bridge_distill_step,
                      make_distill_step, make_fast_distill_step)
from .experiment import (build_datasets, build_loaders, resume_epoch,
                         run_dir_and_logger, run_epoch)
from .loop import batch_to_device, eval_sceneflow, make_eval_step
from .state import make_optimizer, set_learning_rate, step_lr

# fast_distillTrain.py:142-144: eval every FAST_RATIO epochs between FROM/UNTIL
FAST_FROM, FAST_UNTIL, FAST_RATIO = 20, 400, 5
# (teacher, student) presets of each mode: distilTrain.py:103-105,
# distillBridge.py, fast_distillTrain.py:103-105
MODE_PRESETS = {"standard": ("teacher", "lighttoken_res"),
                "bridge": ("teacher", "lighttoken_res"),
                "fast": ("bifeat", "fg")}


def compute_teacher_history(t_model, loader: Iterable,
                            max_batches: Optional[int] = None,
                            mesh: Optional[Mesh] = None) -> list:
    """The frozen teacher's multi-scale loss on each batch of loader
    (numpy batches, pos1, pos2, norm1, norm2, flow, paths), which
    attentiveImitationLoss normalises by (distilTrain.py:142). With mesh,
    each rank runs its rows and every rank gets the global batch's loss:
    the same history as on one device."""
    device = next(t_model.parameters()).device
    history = []
    for i, batch_np in enumerate(loader):
        if max_batches is not None and i >= max_batches:
            break
        batch = batch_to_device(batch_np, device, mesh=mesh)
        out = global_view(mesh, apply_frozen(t_model, batch))
        history.append(float(loss_lib.multi_scale_loss(
            out["flows"], global_view(mesh, batch)["flow"],
            out["fps_idx1"])))
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


def _load_teacher(preset: str, ckpt_path: Optional[str], device
                  ) -> BidPointFlowNet:
    """The frozen teacher: seeded (seed 1) weights, replaced by those of
    ckpt_path when one is given (a port checkpoint, a JAX .msgpack or a
    reference .pth)."""
    model = BidPointFlowNet(PRESETS[preset], device=device,
                            generator=torch.Generator().manual_seed(1))
    if ckpt_path:
        model.load_state_dict(load_weights(ckpt_path, preset), strict=True)
    model.eval()
    return model


def distill(args: Config, mode: str = "standard", device="cuda",
            max_epochs: Optional[int] = None,
            max_steps_per_epoch: Optional[int] = None):
    """mode: standard (distilTrain) | bridge (distillBridge) | fast
    (fast_distillTrain). args.pretrain resumes the student (and, in bridge
    mode, the Bridge and its optimizer) from a checkpoint.

    Returns (student, optimizer, best_epe, run_dir, history), history as
    train_teacher's (its epe None where fast mode skips the eval)."""
    device = resolve_device(device)
    t_preset, s_preset = MODE_PRESETS[mode]
    t_preset = args.get("teacher_preset", t_preset)
    s_preset = args.get("student_preset", s_preset)

    mesh = make_mesh(devices=device)
    run_dir, logger = run_dir_and_logger(
        mesh, args.get("experiment_dir", "./experiment"), args.model_name,
        f"{args.model_name}_kd_{mode}", "train_kd.txt", tag=f"-KD-{mode}")
    logger.info("PARAMETER ... %s", dict(args))

    train_ds, val_ds = build_datasets(args)
    global_bs = resolve_global_batch(
        args.batch_size, args.get("batch_size_per_device", False), mesh.size)
    train_loader, val_loader = build_loaders(args, train_ds, val_ds,
                                             global_bs)
    # the KD losses reduce over the batch, so a global batch that does not
    # divide over the mesh runs unsharded (distilTrain.py:108-114's
    # DataParallel gating, as the JAX package has it)
    mesh, sharding = data_parallel_sharding(global_bs, logger, mesh)
    step_mesh = sharding.mesh if sharding is not None else None
    # drawn as the JAX package draws it (to initialise its models), so both
    # packages see the same shuffles; the bridge's width is read from it
    first = next(iter(train_loader))
    teacher_ckpt = None
    if args.get("ckpt_dir") and args.get("teacher_model"):
        teacher_ckpt = osp.join(args.ckpt_dir, args.teacher_model)
    t_model = _load_teacher(t_preset, teacher_ckpt, device)
    s_model = BidPointFlowNet(PRESETS[s_preset], device=device,
                              generator=torch.Generator().manual_seed(0))
    optimizer = make_optimizer(s_model, args.learning_rate,
                               args.weight_decay)

    extra = {}
    if mode == "bridge":
        layer = args.get("hint_layer", 3)
        width = apply_frozen(t_model, batch_to_device(first, device))[
            "feat1s"][layer].shape[-1]
        bridge = Bridge(width, feat_ch=args.get("bridge_feat_ch", 512),
                        device=device,
                        generator=torch.Generator().manual_seed(2))
        b_opt = make_optimizer(bridge, args.learning_rate, args.weight_decay)
        # the Bridge and its optimizer travel with the student checkpoint
        extra = {"bridge_params": bridge, "bridge_opt": b_opt}

    init_epoch, best_epe = 0, float("inf")
    if args.get("pretrain"):
        ckpt_epoch, best_epe, _ = restore_train_state(
            args.pretrain, s_model, optimizer, extra=extra)
        init_epoch = resume_epoch(ckpt_epoch, best_epe)
        logger.info("student resume from %s (epoch %d, best epe %.4f)",
                    args.pretrain, init_epoch, best_epe)
    replicate(mesh, t_model)
    replicate(mesh, s_model)
    if mode == "bridge":
        replicate(mesh, bridge)

    if mode == "standard":
        # the reference default cross_biDirection_loss_ht needs student hint
        # layers twice the teacher's width; the shipped config names
        # biDirection_loss_ht
        loss_name = args.get("kd_loss", "cross_biDirection_loss_ht")
        named = make_named_loss(loss_name, args)
        t_history = None
        if loss_name == "attentiveImitationLoss":
            t_history = compute_teacher_history(
                t_model, train_loader, max_batches=args.get("history_batches"),
                mesh=step_mesh)
        step = make_distill_step(
            t_model, s_model, optimizer,
            loss_fn=lambda s_out, t_out, b: named(s_out, t_out, b,
                                                  t_history=t_history),
            mesh=step_mesh)
    elif mode == "fast":
        step = make_fast_distill_step(
            t_model, s_model, optimizer, gamma=args.get("gamma", 0.6),
            layers=tuple(args.get("hint_layers", (1, 2))), mesh=step_mesh)
    else:
        step = make_bridge_distill_step(
            t_model, s_model, bridge, optimizer, b_opt,
            gamma=args.get("gamma", 0.3), beta=args.get("beta", 0.8),
            layer=layer, mesh=step_mesh)

    eval_step = make_eval_step(s_model)
    history = []
    epochs = max_epochs if max_epochs is not None else args.epochs
    try:
        for epoch in range(init_epoch, epochs):
            t0 = time.perf_counter()
            lr = step_lr(args.learning_rate, epoch)
            set_learning_rate(optimizer, lr)
            rec = run_epoch(step, train_loader, device, max_steps_per_epoch,
                            mesh=step_mesh)
            logger.info("EPOCH %d %s mean loss: %f", epoch, blue("train"),
                        rec["loss"])
            rec.update(epoch=epoch, lr=lr, epe=None, eval_loss=None,
                       checkpoint=None, eval_s=0.0)

            do_eval = True
            if mode == "fast" and FAST_FROM <= epoch <= FAST_UNTIL:
                do_eval = epoch % FAST_RATIO == 0
            if do_eval:
                t_eval = time.perf_counter()
                rec["epe"], rec["eval_loss"] = eval_sceneflow(
                    eval_step, val_loader, device, mesh=step_mesh)
                rec["eval_s"] = time.perf_counter() - t_eval
                logger.info("EPOCH %d %s mean epe3d: %f  eval loss: %f",
                            epoch, blue("eval"), rec["epe"],
                            rec["eval_loss"])
                if rec["epe"] < best_epe:
                    best_epe = rec["epe"]
                    if mesh.is_main:
                        rec["checkpoint"] = save_checkpoint(
                            osp.join(run_dir, "checkpoints"), "S", epoch,
                            best_epe, full_state_tree(s_model, optimizer,
                                                      epoch, best_epe,
                                                      extra=extra))
                    logger.info("Save model to %s", rec["checkpoint"])
            rec["seconds"] = time.perf_counter() - t0
            logger.info("EPOCH %d wall %.3f s (loader wait %.3f s, %d "
                        "steps %.3f s, eval %.3f s)", epoch, rec["seconds"],
                        rec["load_s"], rec["steps"], rec["train_s"],
                        rec["eval_s"])
            history.append(rec)
    finally:
        train_loader.close()
        val_loader.close()
    return s_model, optimizer, best_epe, run_dir, history
