"""FlyingThings3D-subset preprocessing: disparity / flow -> point-cloud
pairs.

The port's copy of kd_pointcloud_tpu/data/preprocess/ft3d.py (the
reference's data_preprocess/process_flyingthings3d_subset.py +
flyingthings3d_utils.py): per frame, back-project disparity to a cloud
(fixed synthetic camera f = -1050, cx = 479.5, cy = 269.5, baseline 1),
build pc2 from optical flow + disparity change, drop occluded pixels,
optionally keep only points nearer than 35 m. Its .npy files are the JAX
preprocessor's, byte for byte.

Usage: python -m kd_pointcloud_tpu_torch.data.preprocess.ft3d \\
           --raw_data_path RAW --save_path OUT [--only_save_near_pts]
"""

from __future__ import annotations

import argparse
import multiprocessing
import os
import os.path as osp
from concurrent.futures import ProcessPoolExecutor

import numpy as np

from . import io

F_DEFAULT, CX_DEFAULT, CY_DEFAULT = -1050.0, 479.5, 269.5
BASELINE = 1.0


def _grid(height: int, width: int):
    px = np.tile(np.arange(width, dtype=np.float32)[None, :], (height, 1))
    py = np.tile(np.arange(height, dtype=np.float32)[:, None], (1, width))
    return px, py


def pixel2pc(disparity: np.ndarray, f: float = F_DEFAULT,
             cx: float = CX_DEFAULT, cy: float = CY_DEFAULT) -> np.ndarray:
    """Disparity map -> (H, W, 3) cloud (flyingthings3d_utils.py:21-32)."""
    h, w = disparity.shape
    px, py = _grid(h, w)
    depth = -1.0 * f * BASELINE / disparity
    x = (px - cx) * -1.0 / disparity
    y = (py - cy) * 1.0 / disparity
    return np.stack([x, y, depth], axis=-1)


def next_pixel2pc(flow: np.ndarray, disparity: np.ndarray,
                  f: float = F_DEFAULT, cx: float = CX_DEFAULT,
                  cy: float = CY_DEFAULT) -> np.ndarray:
    """Next-frame cloud from flow + next disparity
    (flyingthings3d_utils.py:4-18)."""
    h, w = disparity.shape
    px, py = _grid(h, w)
    depth = -1.0 * f * BASELINE / disparity
    x = (px - cx + flow[..., 0]) * -1.0 / disparity
    y = (py - cy + flow[..., 1]) * 1.0 / disparity
    return np.stack([x, y, depth], axis=-1)


def process_one_file(root_path: str, save_path: str, split: str, fname: str,
                     save_near: bool = False):
    """One frame -> <save_path>/<split>/<fname>/pc{1,2}.npy
    (process_flyingthings3d_subset.py:26-65)."""
    out_dir = osp.join(save_path, split, fname)
    os.makedirs(out_dir, exist_ok=True)

    disp1 = io.read(osp.join(root_path, split, "disparity", "left",
                             fname + ".pfm"))
    disp1_occ = io.read(osp.join(root_path, split, "disparity_occlusions",
                                 "left", fname + ".png"))
    disp1_change = io.read(osp.join(root_path, split, "disparity_change",
                                    "left", "into_future", fname + ".pfm"))
    flow = io.read(osp.join(root_path, split, "flow", "left", "into_future",
                            fname + ".flo"))
    flow_occ = io.read(osp.join(root_path, split, "flow_occlusions", "left",
                                "into_future", fname + ".png"))

    pc1 = pixel2pc(disp1)
    pc2 = next_pixel2pc(flow, disp1 + disp1_change)

    valid = np.logical_and(disp1_occ == 0, flow_occ == 0)
    pc1, pc2 = pc1[valid], pc2[valid]

    if save_near:
        near = np.logical_and(pc1[..., -1] > -35.0, pc2[..., -1] > -35.0)
        pc1, pc2 = pc1[near], pc2[near]

    np.save(osp.join(out_dir, "pc1.npy"), pc1)
    np.save(osp.join(out_dir, "pc2.npy"), pc2)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--raw_data_path", required=True)
    ap.add_argument("--save_path", required=True)
    ap.add_argument("--only_save_near_pts", dest="save_near",
                    action="store_true")
    ap.add_argument("--workers", type=int, default=4)
    args = ap.parse_args(argv)

    jobs = []
    for split in ("train", "val"):
        frame_dir = osp.join(args.raw_data_path, split, "disparity_change",
                             "left", "into_future")
        jobs += [(split, f.split(".")[0]) for f in sorted(os.listdir(
            frame_dir))]

    with ProcessPoolExecutor(
            max_workers=args.workers,
            mp_context=multiprocessing.get_context("spawn")) as pool:
        futs = [pool.submit(process_one_file, args.raw_data_path,
                            args.save_path, split, fname, args.save_near)
                for split, fname in jobs]
        for f in futs:
            f.result()
    print(f"Finish all! {len(jobs)} frames")
    return len(jobs)


if __name__ == "__main__":
    main()
