"""Train and eval steps.

Port of kd_pointcloud_tpu/train/loop.py make_train_step / make_eval_step /
batch_to_device / eval_sceneflow (reference train_bid_pointconv.py:129-210):
one train step is the forward in train mode (BatchNorm on batch
statistics), the multi-scale loss through the pc1 FPS chain, backward and
one optimizer step. PyTorch runs eagerly: a step is a plain function over
the model and optimizer, which it updates in place.

On a data mesh (parallel/) each rank runs its rows of the global batch
(batch_to_device(..., mesh=)), and the step computes what the JAX
package's sharded step computes: BatchNorm statistics over the global rows,
the loss of the global batch, evaluated on every rank over the gathered
outputs, and its gradient, averaged over the ranks, so every rank takes the
same optimizer update. Off a mesh, or on a mesh of one rank, the step is
the single-device one.

A train step opens the spans train.forward (train mode, zero_grad, the
forward), train.loss, train.backward and train.optimizer (the gradients'
mean over a mesh and the update); they are on only while a profiler
records (perf/trace.py).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from ..data.loader import PAD_PATH
from ..device import use_full_fp32
from ..eval.runner import flow0_of
from ..losses import multi_scale_loss, multi_scale_loss_per_sample
from ..nn.pointconv import batch_stats_over
from ..parallel import Mesh, gather_rows, global_view, shard_batch, sync_grads
from ..perf.trace import annotate


def supervised_loss(out, batch) -> torch.Tensor:
    """The default loss: multiScaleLoss of out["flows"] against
    batch["flow"] through the pc1 FPS chain. With batch["weight"] (the
    padded-batch protocol, pad rows weigh 0) it is the weighted mean of the
    per-sample losses, so pad rows do not count."""
    if "weight" in batch:
        per = multi_scale_loss_per_sample(out["flows"], batch["flow"],
                                          out["fps_idx1"])
        w = batch["weight"]
        return (per * w).sum() / w.sum()
    return multi_scale_loss(out["flows"], batch["flow"], out["fps_idx1"])


def _forward(model, batch):
    return model(batch["pos1"], batch["pos2"], batch["norm1"], batch["norm2"])


def make_train_step(model, optimizer, loss_fn: Optional[Callable] = None,
                    mesh: Optional[Mesh] = None):
    """fn(batch) -> loss (a detached scalar tensor): forward in train mode,
    loss_fn(out, batch) (default supervised_loss), backward, one optimizer
    step. The gradients stay in the parameters' .grad until the next
    step.

    With mesh, batch holds this rank's rows; loss_fn sees the outputs and
    the batch of the whole global batch (parallel.GatheredView), the
    returned loss is the global one on every rank, and .grad holds the
    global gradient, averaged over the ranks."""
    loss_fn = loss_fn or supervised_loss
    use_full_fp32()

    def step(batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        with annotate("train.forward"):
            model.train()
            optimizer.zero_grad(set_to_none=True)
            with batch_stats_over(model, mesh):
                out = _forward(model, batch)
        with annotate("train.loss"):
            loss = loss_fn(global_view(mesh, out), global_view(mesh, batch))
        with annotate("train.backward"):
            loss.backward()
        with annotate("train.optimizer"):
            sync_grads(mesh, model.parameters())
            optimizer.step()
        return loss.detach()

    return step


def epe3d_per_sample(flow0: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(((flow0 - gt) ** 2).sum(-1)).mean(-1)


def make_eval_step(model):
    """fn(batch) -> per-sample (epe3d (B,), loss (B,), flow0 (B, N, 3)):
    the eval forward (BatchNorm on running statistics, no autograd), the
    multi-scale loss and EPE3D."""
    use_full_fp32()

    def step(batch: Dict[str, torch.Tensor]):
        model.eval()
        with torch.inference_mode():
            out = _forward(model, batch)
            loss = multi_scale_loss_per_sample(out["flows"], batch["flow"],
                                               out["fps_idx1"])
            flow0 = flow0_of(out)
            return epe3d_per_sample(flow0, batch["flow"]), loss, flow0

    return step


def batch_to_device(batch_np, device, pad_to: Optional[int] = None,
                    mesh: Optional[Mesh] = None) -> Dict[str, torch.Tensor]:
    """A loader batch (pos1, pos2, norm1, norm2, flow, paths) of numpy
    arrays -> a dict of float32 tensors on device. pad_to pads the batch
    axis (repeating the last row) up to that size and attaches a 0/1
    "weight" row mask; the default loss then averages over real rows
    only. With mesh, only this rank's rows of the (padded) global batch go
    to the device (parallel.shard_batch)."""
    pos1, pos2, norm1, norm2, flow, _paths = batch_np
    batch = dict(pos1=pos1, pos2=pos2, norm1=norm1, norm2=norm2, flow=flow)
    if pad_to is not None and pos1.shape[0] != pad_to:
        n = pos1.shape[0]
        reps = pad_to - n
        batch = {k: np.concatenate([v, np.repeat(v[-1:], reps, axis=0)])
                 for k, v in batch.items()}
        batch["weight"] = np.concatenate(
            [np.ones(n, np.float32), np.zeros(reps, np.float32)])
    elif pad_to is not None:
        batch["weight"] = np.ones(pos1.shape[0], np.float32)
    if mesh is not None:
        batch = shard_batch(mesh, batch)
    return {k: torch.as_tensor(np.asarray(v, np.float32)).to(device)
            for k, v in batch.items()}


def eval_sceneflow(eval_step, loader, device,
                   pad_to: Optional[int] = None,
                   mesh: Optional[Mesh] = None) -> Tuple[float, float]:
    """Mean EPE3D and eval loss over a loader's batches. Per-sample results
    of pad rows (path PAD_PATH, or added by pad_to) are masked out; one host
    sync at the end. With mesh, each rank runs its rows and gathers every
    rank's per-sample results, so every rank returns the single-device
    numbers."""
    epes, losses, masks = [], [], []
    for batch_np in loader:
        epe3d, loss, _ = eval_step(batch_to_device(batch_np, device, pad_to,
                                                   mesh))
        if mesh is not None:
            epe3d, loss = gather_rows(mesh, epe3d), gather_rows(mesh, loss)
        epes.append(epe3d)
        losses.append(loss)
        real = [p != PAD_PATH for p in batch_np[5]]
        if pad_to is not None:
            real += [False] * (pad_to - len(real))
        masks.append(torch.tensor(real, dtype=torch.float32, device=device))
    epe, loss, mask = (torch.cat(t) for t in (epes, losses, masks))
    denom = mask.sum().clamp_min(1.0)
    return (float((epe * mask).sum() / denom),
            float((loss * mask).sum() / denom))
