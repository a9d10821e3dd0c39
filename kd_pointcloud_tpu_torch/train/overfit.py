"""Fixed-batch training trajectory, and its command-line entry.

Port of kd_pointcloud_tpu/train/overfit.py: the reference trainer's hot loop
(train_bid_pointconv.py:117-155: forward -> multiScaleLoss -> backward ->
Adam(lr=1e-3, wd=1e-4), no scheduler inside the horizon) over a fixed list
of batches, recording the loss and the train-mode l0 EPE3D of every step.

    python -m kd_pointcloud_tpu_torch.train.overfit [--npz PATH] \\
        [--init PATH] [--steps 20] [--batch 3] [--points 8192] \\
        [--device cuda]

is the counterpart of scripts/overfit_convergence.py. It trains the teacher
from seeded random weights, or from --init (a reference .pth, a flax
.msgpack of the JAX package or a checkpoint of the port), on the batches of
an .npz in the overfit fixture's layout (b{i}_pos1 / b{i}_pos2 / b{i}_flow)
when given one, and otherwise on one batch of seeded synthetic pairs
(eval.synthetic_pairs),
with the reference recipe's Adam (lr 1e-3, weight decay 1e-4). It runs on the
card unless told --device cpu, and raises when no card is present.
"""

from __future__ import annotations

import argparse
import json
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..losses import multi_scale_loss
from .checkpoints import load_weights
from .loop import epe3d_per_sample, flow0_of, make_train_step
from .state import make_optimizer


def make_trajectory_step(model, optimizer):
    """fn(batch) -> (loss, l0 EPE3D), both detached scalars, after one train
    step: the two observables the reference fixture records a step."""
    seen = {}

    def loss_fn(out, batch):
        seen["epe"] = epe3d_per_sample(flow0_of(out).detach(),
                                       batch["flow"]).mean()
        return multi_scale_loss(out["flows"], batch["flow"], out["fps_idx1"])

    train = make_train_step(model, optimizer, loss_fn)

    def step(batch):
        loss = train(batch)
        return loss, seen["epe"]

    return step


def run_trajectory(model, batches: Sequence[Dict[str, torch.Tensor]],
                   n_steps: int, lr: float = 1e-3, wd: float = 1e-4,
                   log_every: int = 50
                   ) -> Tuple[np.ndarray, np.ndarray, torch.optim.Adam]:
    """n_steps over the cyclically repeated batches, training the model in
    place; returns the per-step (losses, epes) float64 arrays and the
    optimizer."""
    optimizer = make_optimizer(model, lr, wd)
    step = make_trajectory_step(model, optimizer)
    losses: List[float] = []
    epes: List[float] = []
    for i in range(n_steps):
        loss, epe = step(batches[i % len(batches)])
        losses.append(float(loss))
        epes.append(float(epe))
        if log_every and (i % log_every == 0 or i == n_steps - 1):
            print(f"step {i}: loss {losses[-1]:.6f} epe {epes[-1]:.4f}",
                  flush=True)
    return (np.asarray(losses, np.float64), np.asarray(epes, np.float64),
            optimizer)


def load_overfit_batches(npz_path: str, device="cuda"
                         ) -> List[Dict[str, torch.Tensor]]:
    """The overfit fixture's batch list (b{i}_{pos1,pos2,flow}); norm1/norm2
    alias the positions, as the reference trainer's model(pos1, pos2, pos1,
    pos2) call."""
    z = np.load(npz_path)
    n = len([k for k in z.files if k.startswith("b") and k.endswith("_pos1")])
    batches = []
    for i in range(n):
        b = {k: torch.as_tensor(np.asarray(z[f"b{i}_{k}"], np.float32))
             .to(device) for k in ("pos1", "pos2", "flow")}
        b["norm1"], b["norm2"] = b["pos1"], b["pos2"]
        batches.append(b)
    return batches


def synthetic_batches(n_batches: int, batch: int, npoints: int, seed: int,
                      device="cuda") -> List[Dict[str, torch.Tensor]]:
    """n_batches of `batch` seeded synthetic pairs (eval.synthetic_pairs)."""
    from ..eval import synthetic_pairs

    pairs = synthetic_pairs(n_batches * batch, npoints, seed=seed)
    keys = ("pos1", "pos2", "norm1", "norm2", "flow")
    return [{k: torch.from_numpy(np.stack([p[j] for p in
                                           pairs[i * batch:(i + 1) * batch]]))
             .to(device) for j, k in enumerate(keys)}
            for i in range(n_batches)]


def main(argv=None) -> dict:
    from ..models import PRESETS, BidPointFlowNet, tiny_config

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--npz", help="batches in the overfit fixture's layout")
    ap.add_argument("--init", help="initial weights: a reference .pth, a "
                    "JAX package .msgpack or a checkpoint of the port")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=3)
    ap.add_argument("--points", type=int, default=8192)
    ap.add_argument("--preset", default="teacher")
    ap.add_argument("--tiny", action="store_true",
                    help="tiny_config shapes of the preset (tests)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", help="write losses and epes to this .npz")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    if args.tiny:
        cfg = tiny_config(args.preset)
    else:
        cfg = PRESETS[args.preset]
    model = BidPointFlowNet(cfg, device=device,
                            generator=torch.Generator().manual_seed(args.seed))
    if args.init:
        model.load_state_dict(load_weights(args.init, args.preset),
                              strict=True)
    if args.npz:
        batches = load_overfit_batches(args.npz, device)
    else:
        batches = synthetic_batches(1, args.batch, args.points, args.seed,
                                    device)
    losses, epes, _ = run_trajectory(model, batches, args.steps,
                                     log_every=10)
    if args.out:
        np.savez(args.out, losses=losses, epes=epes, n_steps=args.steps)
    summary = dict(device=str(device), preset=cfg.name, init=args.init,
                   steps=args.steps,
                   loss_first=losses[0], loss_last=losses[-1],
                   epe_first=epes[0], epe_last=epes[-1])
    print(json.dumps(summary), flush=True)
    return summary


if __name__ == "__main__":
    main()
