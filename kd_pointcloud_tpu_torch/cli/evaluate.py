"""Evaluation: python -m kd_pointcloud_tpu_torch.cli.evaluate <config>.yaml
[--device cpu] (scripts/evaluate.py; the reference's
evaluate_bid_pointconv.py). Loads the config's pretrain weights (a
reference .pth, a JAX package .msgpack or a checkpoint of the port,
relative to ckpt_dir), sweeps the val set and prints EPE3D / ACC3DS /
ACC3DR / Outliers3D / EPE2D / ACC2D and the eval loss. max_samples cuts
the sweep short; KITTI's calibration is read from the reference layout
(calib_dir_for(data_root)). With data_parallel: true, under torchrun, the
sweep runs data-parallel over the ranks (a batch_size that does not divide
over them runs on every rank whole, and logs it); rank 0 prints."""

import os.path as osp

from ..data import DataLoader
from ..device import resolve_device
from ..eval import calib_dir_for, evaluate_model
from ..parallel import make_mesh
from ..train.checkpoints import load_weights
from ..train.experiment import build_datasets, build_model
from ..utils import make_logger
from . import parse_config


def main(argv=None):
    args, device = parse_config(argv, __doc__)
    device = resolve_device(device)
    mesh = make_mesh(devices=device)
    logger = make_logger("evaluate", to_stdout=mesh.is_main)
    model = build_model(args, device=device)
    _, val_ds = build_datasets(args, need_train=False)
    if args.get("max_samples"):
        val_ds.samples = val_ds.samples[: args.max_samples]
    # pad_last: batch > 1 sweeps keep every sample (the metrics mask pads)
    loader = DataLoader(val_ds, args.batch_size, shuffle=False,
                        drop_last=False, pad_last=True,
                        num_workers=args.get("workers", 2))
    try:
        # the JAX entry draws one batch to shape its initialisation;
        # drawing it too keeps the sampled points of both the same
        next(iter(loader))
        if args.get("pretrain"):
            path = args.pretrain
            if args.get("ckpt_dir") and not osp.isabs(path):
                path = osp.join(args.ckpt_dir, path)
            model.load_state_dict(
                load_weights(path, args.get("model_preset", "teacher")),
                strict=True)
            logger.info("loaded %s", path)
        if not args.get("data_parallel"):
            mesh = None
        elif args.batch_size % mesh.size != 0:
            logger.info("batch_size %d not divisible by %d devices — "
                        "running single-device", args.batch_size, mesh.size)
            mesh = None
        results = evaluate_model(model, loader, logger=logger,
                                 calib_dir=calib_dir_for(args.data_root),
                                 mesh=mesh)
    finally:
        loader.close()
    if mesh is None or mesh.is_main:
        for k, v in results.items():
            print(f"{k}: {v:.4f}")
    return results


if __name__ == "__main__":
    main()
