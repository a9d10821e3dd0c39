"""KITTI Scene Flow 2015 preprocessing: disparity + flow -> point-cloud
pairs.

The port's copy of kd_pointcloud_tpu/data/preprocess/kitti.py (the
reference's data_preprocess/process_kitti.py + kitti_utils.py): per frame,
read disp_occ_0 / disp_occ_1 / flow_occ, back-project through the
per-scene P_rect_02 intrinsics (baseline 0.54 m) and save the valid-pixel
clouds; its .npy files are the JAX preprocessor's, byte for byte. The
calibration directory (KITTI's calib_cam_to_cam) is an argument, and the
frames are those present under training/disp_occ_0 (all 200 in the
dataset).

Usage: python -m kd_pointcloud_tpu_torch.data.preprocess.kitti RAW_ROOT OUT \\
           --calib_root DIR
"""

from __future__ import annotations

import argparse
import multiprocessing
import os
import os.path as osp
import re
from concurrent.futures import ProcessPoolExecutor

import numpy as np

from .io import read_uint16_png

BASELINE = 0.54


def load_disp(path: str):
    """16-bit PNG / 256; 0 = invalid (kitti_utils.py:41-49)."""
    arr = read_uint16_png(path)
    valid = arr > 0
    disp = arr.astype(np.float32) / 256.0
    disp[~valid] = -1.0
    return disp, valid


def load_op_flow(path: str):
    """(u, v) = (png[..., 0:2] - 2^15) / 64; png[..., 2] == 1 marks valid
    (kitti_utils.py:52-57)."""
    arr = read_uint16_png(path)
    valid = arr[..., -1] == 1
    flow = (arr.astype(np.float32)[..., :-1] - 2 ** 15) / 64.0
    return flow, valid


def disp_to_depth(disp: np.ndarray, valid: np.ndarray,
                  focal_px: float) -> np.ndarray:
    depth = focal_px * BASELINE / (disp + 1e-5)
    depth[~valid] = -1.0
    return depth


def pixel2xyz(depth: np.ndarray, P_rect: np.ndarray,
              px: np.ndarray = None, py: np.ndarray = None) -> np.ndarray:
    """Back-project through a rectified pinhole P (kitti_utils.py:5-27);
    x and y negated to match the FT3D-convention frame."""
    if P_rect[0, 0] != P_rect[1, 1]:
        raise ValueError("P_rect_02 with fx != fy")
    focal = P_rect[0, 0]
    h, w = depth.shape
    if px is None:
        px = np.tile(np.arange(w, dtype=np.float32)[None, :], (h, 1))
    if py is None:
        py = np.tile(np.arange(h, dtype=np.float32)[:, None], (1, w))
    const_x = P_rect[0, 2] * depth + P_rect[0, 3]
    const_y = P_rect[1, 2] * depth + P_rect[1, 3]
    x = (px * (depth + P_rect[2, 3]) - const_x) / focal
    y = (py * (depth + P_rect[2, 3]) - const_y) / focal
    pc = np.stack([x, y, depth], axis=-1)
    pc[..., :2] *= -1.0
    return pc


def read_p_rect(calib_path: str) -> np.ndarray:
    with open(calib_path) as fd:
        lines = [line for line in fd if line.startswith("P_rect_02")]
    if len(lines) != 1:
        raise ValueError(f"{calib_path}: {len(lines)} P_rect_02 lines")
    return np.array([float(v) for v in lines[0].split()[1:]],
                    dtype=np.float32).reshape(3, 4)


def process_one_frame(data_root: str, save_path: str, calib_root: str,
                      idx: int):
    sidx = f"{idx:06d}"
    P = read_p_rect(osp.join(calib_root, sidx + ".txt"))
    focal = P[0, 0]

    disp1, valid1 = load_disp(osp.join(data_root, "training/disp_occ_0",
                                       sidx + "_10.png"))
    depth1 = disp_to_depth(disp1, valid1, focal)
    pc1 = pixel2xyz(depth1, P)

    disp2, valid2 = load_disp(osp.join(data_root, "training/disp_occ_1",
                                       sidx + "_10.png"))
    depth2 = disp_to_depth(disp2, valid2, focal)

    flow, valid_flow = load_op_flow(osp.join(data_root, "training/flow_occ",
                                             sidx + "_10.png"))
    valid_disp = np.logical_and(valid1, valid2)
    ok = np.logical_and(valid_flow, valid_disp)

    h, w = flow.shape[:2]
    px2 = np.where(ok, np.arange(w, dtype=np.float32)[None, :] + flow[..., 0],
                   0.0)
    py2 = np.where(ok, np.arange(h, dtype=np.float32)[:, None] + flow[..., 1],
                   0.0)
    pc2 = pixel2xyz(depth2, P, px=px2, py=py2)

    out_dir = osp.join(save_path, sidx)
    os.makedirs(out_dir, exist_ok=True)
    np.save(osp.join(out_dir, "pc1.npy"), pc1[ok])
    np.save(osp.join(out_dir, "pc2.npy"), pc2[ok])


def frames(data_root: str) -> list:
    """The frame numbers under <data_root>/training/disp_occ_0."""
    found = (re.fullmatch(r"(\d{6})_10\.png", f) for f in os.listdir(
        osp.join(data_root, "training", "disp_occ_0")))
    return sorted(int(m.group(1)) for m in found if m)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("data_root")
    ap.add_argument("save_path")
    ap.add_argument("--calib_root", required=True,
                    help="KITTI's calib_cam_to_cam directory")
    ap.add_argument("--workers", type=int, default=4)
    args = ap.parse_args(argv)

    todo = frames(args.data_root)
    with ProcessPoolExecutor(
            max_workers=args.workers,
            mp_context=multiprocessing.get_context("spawn")) as pool:
        futs = [pool.submit(process_one_frame, args.data_root,
                            args.save_path, args.calib_root, i)
                for i in todo]
        for f in futs:
            f.result()
    return len(todo)


if __name__ == "__main__":
    main()
