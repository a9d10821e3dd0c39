"""Evaluation sweep: EPE3D / ACC3DS / ACC3DR / Outliers3D / EPE2D / ACC2D
and the eval loss, over a data loader.

Port of kd_pointcloud_tpu/eval/runner.py (reference
evaluate_bid_pointconv.py:27-172). On the device path all six metrics --
the 2-D ones through the projection, fed each sample's intrinsics as a row
(the FT3D camera, or KITTI's P_rect_02 read from calib_dir) -- are computed
on the model's device beside the forward; the sweep keeps the per-sample
rows there and syncs once at the end, masking the loader's pad rows
(PAD_PATH). ``device_metrics=False`` is the host path: the forward on the
device, numpy metrics on worker threads, as the reference computes them,
for cross-checking. With a data mesh (parallel/), the device path runs
data-parallel: each rank its rows of every batch, the per-sample rows
gathered onto every rank. Unlike the JAX package's host path, the host
path leaves pad rows out too and takes each sample's own loss, so both
paths average the same numbers (JAX's host path counts pad rows, and on a
padded KITTI batch looks for a calib file named after the pad path).

With no scene on disk, ``synthetic_pairs`` makes seeded 8192-point pairs,
and ``pairs_loader`` turns pairs into batch-1 loader batches whose paths
select the FT3D camera.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..data.loader import PAD_PATH
from ..device import use_full_fp32
from ..losses import multi_scale_loss_per_sample
from ..parallel import Mesh, gather_rows, shard_batch
from ..perf.trace import annotate
from ..utils.logging import AverageMeter
from .geometry import (FT3D_INTRINSICS, INTRINSIC_KEYS, get_batch_2d_flow,
                       is_kitti, read_kitti_intrinsics)
from .graphs import EvalGraphs
from .metrics import (evaluate_2d, evaluate_2d_torch, evaluate_3d,
                      evaluate_3d_torch)

METRIC_KEYS = ("epe3d", "acc3ds", "acc3dr", "outliers", "epe2d", "acc2d",
               "loss")


def flow0_of(out) -> torch.Tensor:
    """The model's finest flow: the last iteration's where l0 holds a
    per-iteration list (iters > 1)."""
    flow0 = out["flows"][0]
    return flow0[-1] if isinstance(flow0, (list, tuple)) else flow0


def make_eval_forward(model):
    """fn(pos1, pos2, norm1, norm2) -> flow0 (B, N, 3): the eval forward,
    without autograd, with the model in eval mode (BatchNorm from running
    statistics), in the span eval.forward (perf/trace.py). On the card, a
    model whose forward is free of host syncs answers from a CUDA graph of
    the forward, captured once an input signature (eval/graphs.py says
    when, and what it holds); flow0 is then a fresh tensor all the same."""
    use_full_fp32()
    model.eval()
    graphs = EvalGraphs(model, lambda *args: flow0_of(model(*args)))

    def fwd(pos1, pos2, norm1, norm2):
        with annotate("eval.forward"), torch.inference_mode():
            return graphs(pos1, pos2, norm1, norm2)

    return fwd


def project_points(pc: torch.Tensor, intr: torch.Tensor) -> torch.Tensor:
    """Batched 3D -> 2D projection with per-sample intrinsics.
    pc: (B, N, 3); intr: (B, 6) rows of (f, cx, cy, constx, consty, constz)
    (utils/geometry.py:61 semantics). Returns (B, N, 2)."""
    f, cx, cy, constx, consty, constz = (intr[:, i:i + 1] for i in range(6))
    x = (pc[..., 0] * f + cx * pc[..., 2] + constx) / (pc[..., 2] + constz)
    y = (pc[..., 1] * f + cy * pc[..., 2] + consty) / (pc[..., 2] + constz)
    return torch.stack([x, y], dim=-1)


def make_eval_metrics_step(model, with_2d: bool = True):
    """fn(pos1, pos2, norm1, norm2, flow, intr) -> (B, 7) per-sample rows
    [epe3d, acc3ds, acc3dr, outliers, epe2d, acc2d, loss] (METRIC_KEYS),
    computed on the model's device, in eval mode without autograd. intr:
    (B, 6) projection intrinsics a sample; with_2d=False puts zeros in the
    2-D columns. The loss column is each sample's own multi-scale loss
    (the JAX package's repeats the batch mean, which counts pad rows in a
    padded batch of two or more real samples)."""
    use_full_fp32()

    def step(pos1, pos2, norm1, norm2, flow, intr):
        model.eval()
        with torch.inference_mode():
            out = model(pos1, pos2, norm1, norm2)
            pred = flow0_of(out)
            loss = multi_scale_loss_per_sample(out["flows"], flow,
                                               out["fps_idx1"])
            epe3d, acc_s, acc_r, outl = evaluate_3d_torch(pred, flow)
            if with_2d:
                px1 = project_points(pos1, intr)
                f_pred = project_points(pos1 + pred, intr) - px1
                f_gt = project_points(pos1 + flow, intr) - px1
                epe2d, acc2d = evaluate_2d_torch(f_pred, f_gt)
            else:
                epe2d = acc2d = torch.zeros_like(epe3d)
            return torch.stack([epe3d, acc_s, acc_r, outl, epe2d, acc2d,
                                loss], dim=-1)

    return step


def _intrinsics_for(paths: Sequence[str], calib_dir: Optional[str] = None
                    ) -> np.ndarray:
    """(B, 6) float32 intrinsics rows: KITTI's per scene, the FT3D camera
    for every other path (pad rows included)."""
    rows = []
    for p in paths:
        if is_kitti(p):
            if calib_dir is None:
                raise ValueError("KITTI scenes need calib_dir for the 2-D "
                                 "metrics")
            intr = read_kitti_intrinsics(p.rsplit("/", 1)[-1], calib_dir)
        else:
            intr = FT3D_INTRINSICS
        rows.append([intr[k] for k in INTRINSIC_KEYS])
    return np.asarray(rows, np.float32)


def _to_device(arrays, device) -> List[torch.Tensor]:
    return [torch.as_tensor(np.asarray(a, np.float32)).to(device)
            for a in arrays]


def _log(logger, results) -> None:
    if logger is not None:
        logger.info(" ".join(f"{k}={v:.4f}" for k, v in results.items()))


def evaluate_model(model, loader, logger=None, with_2d: bool = True,
                   metric_workers: int = 2, device_metrics: bool = True,
                   calib_dir: Optional[str] = None,
                   mesh: Optional[Mesh] = None) -> Dict[str, float]:
    """The six metrics and the mean multi-scale loss over loader's batches
    (pos1, pos2, norm1, norm2, flow, paths), weighted by real samples: rows
    whose path is PAD_PATH do not count. with_2d=False leaves out EPE2D and
    ACC2D. calib_dir holds the KITTI calib files (KITTI scenes only).

    mesh: the device path runs data-parallel over it (every rank returns
    the single-device numbers). It needs loader batch_size % mesh.size == 0
    and pad_last=True, so that every batch divides; otherwise the sweep
    falls back to every rank running whole batches, and logs it."""
    device = next(model.parameters()).device
    if device_metrics:
        if mesh is not None and mesh.size > 1 and (
                getattr(loader, "batch_size", 0) % mesh.size != 0
                or not getattr(loader, "pad_last", False)):
            if logger is not None:
                logger.info(
                    "evaluate_model: loader batch_size=%s incompatible with "
                    "%d-device mesh (needs batch_size %% mesh.size == 0 and "
                    "pad_last=True); falling back to single-device",
                    getattr(loader, "batch_size", None), mesh.size)
            mesh = None
        step = make_eval_metrics_step(model, with_2d=with_2d)
        rows: List[torch.Tensor] = []
        masks: List[np.ndarray] = []
        for pos1, pos2, norm1, norm2, flow, paths in loader:
            intr = (_intrinsics_for(paths, calib_dir) if with_2d else
                    np.zeros((pos1.shape[0], 6), np.float32))
            arrays = (pos1, pos2, norm1, norm2, flow, intr)
            if mesh is not None:
                arrays = shard_batch(mesh, arrays)
            row = step(*_to_device(arrays, device))
            rows.append(row if mesh is None else gather_rows(mesh, row))
            masks.append(np.asarray([p != PAD_PATH for p in paths],
                                    np.float32))
        stacked = torch.cat(rows).cpu().numpy()          # one sync
        mask = np.concatenate(masks)
        mean = (stacked * mask[:, None]).sum(0) / max(mask.sum(), 1.0)
        results = dict(zip(METRIC_KEYS, (float(v) for v in mean)))
        if not with_2d:
            results.pop("epe2d"), results.pop("acc2d")
        _log(logger, results)
        return results

    # ---- host path: the reference's numpy metrics on worker threads
    use_full_fp32()
    model.eval()
    futures = []
    with ThreadPoolExecutor(max_workers=metric_workers) as pool:
        for pos1, pos2, norm1, norm2, flow, paths in loader:
            t = _to_device((pos1, pos2, norm1, norm2, flow), device)
            with torch.inference_mode():
                out = model(*t[:4])
                pred = flow0_of(out)
                loss = multi_scale_loss_per_sample(out["flows"], t[4],
                                                   out["fps_idx1"])
            futures.append(pool.submit(_batch_metrics, pred, loss, pos1,
                                       flow, paths, with_2d, calib_dir))
        meters = {k: AverageMeter() for k in METRIC_KEYS
                  if with_2d or k not in ("epe2d", "acc2d")}
        for f in futures:
            for row in f.result():
                for k, v in row.items():
                    meters[k].update(v)
    results = {k: m.avg for k, m in meters.items()}
    _log(logger, results)
    return results


def _batch_metrics(pred_dev, loss_dev, pos1, flow, paths, with_2d,
                   calib_dir) -> List[Dict[str, float]]:
    """Runs on a worker thread: device -> host copy and numpy metrics; one
    dict a real (not padded) sample."""
    real = [b for b, p in enumerate(paths) if p != PAD_PATH]
    pred = pred_dev.cpu().numpy()[real]
    loss = loss_dev.cpu().numpy()[real]
    pos1, flow = pos1[real], flow[real]
    if with_2d:
        flow_pred_2d, flow_gt_2d = get_batch_2d_flow(
            pos1, pos1 + flow, pos1 + pred, [paths[b] for b in real],
            calib_dir)
    rows: List[Dict[str, float]] = []
    for b in range(len(real)):
        epe3d, acc_s, acc_r, outl = evaluate_3d(pred[b], flow[b])
        row = dict(epe3d=epe3d, acc3ds=acc_s, acc3dr=acc_r, outliers=outl,
                   loss=float(loss[b]))
        if with_2d:
            row["epe2d"], row["acc2d"] = evaluate_2d(flow_pred_2d[b],
                                                     flow_gt_2d[b])
        rows.append(row)
    return rows


def pairs_loader(pairs) -> list:
    """Batch-1 loader batches of (pos1, pos2, norm1, norm2, flow) pairs of
    (N, 3) arrays; the synthetic paths select the FT3D camera."""
    return [tuple(np.asarray(a, np.float32)[None] for a in pair)
            + ([f"synthetic/{i:06d}"],) for i, pair in enumerate(pairs)]


def synthetic_pairs(n: int, npoints: int = 8192, seed: int = 0):
    """n seeded scene pairs shaped like KITTI eval inputs: pc1 uniform in a
    60 x 3 x 35 m box in front of the sensor, pc2 a small rigid motion of pc1
    (yaw up to 0.05 rad, up to 1 m) plus 1 cm noise, flow = pc2 - pc1 row by
    row, and norms equal to positions as in the data pipeline."""
    rng = np.random.RandomState(seed)
    lo, hi = np.array([-30.0, -1.4, 0.0]), np.array([30.0, 1.6, 35.0])
    out = []
    for _ in range(n):
        pc1 = rng.uniform(lo, hi, size=(npoints, 3))
        yaw = rng.uniform(-0.05, 0.05)
        rot = np.array([[np.cos(yaw), 0.0, np.sin(yaw)], [0.0, 1.0, 0.0],
                        [-np.sin(yaw), 0.0, np.cos(yaw)]])
        shift = rng.uniform(-1.0, 1.0, size=3)
        pc2 = pc1 @ rot.T + shift + 0.01 * rng.standard_normal(pc1.shape)
        pc1, pc2 = pc1.astype(np.float32), pc2.astype(np.float32)
        out.append((pc1, pc2, pc1, pc2, pc2 - pc1))
    return out
